"""The cover-pixel predictors of the WS estimate, by network name: the one
place that maps a network to its factory, its seeded initialiser and the
layout of a trained run's ``best.npz``.

- ``unet_<n>``: ``unet.get_model`` and ``unet.init_unet`` (Flax's
  defaults); ``best.npz`` in the Flax layout
  (``convert.unet_state_dict_from_flax`` and its inverse).
- a Restormer configuration of ``restormer.NETWORKS`` (``restormer_gray``):
  ``restormer.restormer`` and ``restormer.init_restormer``; ``best.npz``
  holds its state dict under the published names, one array a parameter
  (no Flax layout exists for it).

``get_model`` builds any of them; ``predictor(network)`` gives the rest.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from . import convert, restormer, unet


class Predictor(NamedTuple):
    build: Callable         # (name, **options) -> nn.Module
    init: Callable          # (model, seed) -> the model, filled
    from_params: Callable   # best.npz's params tree -> state dict
    to_params: Callable     # state dict -> best.npz's params tree


def _state_dict(params: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


def _params(state_dict: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in state_dict.items()}


UNET = Predictor(unet.get_model, unet.init_unet,
                 convert.unet_state_dict_from_flax,
                 convert.flax_params_from_unet_state_dict)
RESTORMER = Predictor(restormer.restormer, restormer.init_restormer,
                      _state_dict, _params)


def predictor(network: str) -> Predictor:
    """The entry of ``network``: a Restormer's where it names one, else the
    U-Net's (whose factory refuses a name that is not ``unet_<n>``)."""
    return RESTORMER if network in restormer.NETWORKS else UNET


def get_model(name: str, in_channels: int = 1, out_channels: int = 1,
              drop_rate: float = None, disable_center: bool = False,
              compute_dtype: torch.dtype = torch.float32,
              fast_conv=False) -> nn.Module:
    """The predictor ``name`` (``unet_<nsteps>`` or ``restormer_gray``);
    a Restormer refuses the options it does not run
    (``restormer.restormer``)."""
    return predictor(name).build(
        name, in_channels=in_channels, out_channels=out_channels,
        drop_rate=drop_rate, disable_center=disable_center,
        compute_dtype=compute_dtype, fast_conv=fast_conv)
