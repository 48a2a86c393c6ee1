"""Device rule of the port's entry points.

``device=None`` means CUDA.  Without a card an entry point raises instead
of quietly running on the CPU; the CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do.  Tensor-level functions do not
come here: they follow the device of the tensor they are given.
"""

import torch

from .utils.errors import UserError


def disable_tf32() -> None:
    """Run f32 convolutions and matmuls in full f32 on the card.

    The JAX package pins ``Precision.HIGHEST`` (models/unet.py,
    ops/filters.py); cuDNN's f32 convolution would otherwise use TF32,
    which keeps about three decimal digits.  These are process-wide
    switches, set by every f32 path that runs on CUDA."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the resolved device is CUDA and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UserError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        disable_tf32()
    return dev
