"""Flax's default kernel initialiser, shared by ``init_unet`` and
``init_b0``."""

import math

import torch
from torch import nn

# the standard deviation of a standard normal cut at +-2, as Flax's
# truncated-normal initialisers divide by it
TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal`` draw of ``shape`` from ``generator``: a
    standard normal cut at +-2, scaled to standard deviation
    1/sqrt(fan_in)."""
    t = nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
    return t * (1.0 / math.sqrt(fan_in) / TRUNC_STD)
