"""Device rule of the port's entry points.

``device=None`` means CUDA.  Without a card an entry point raises instead
of quietly running on the CPU; the CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do.  Tensor-level functions do not
come here: they follow the device of the tensor they are given.
Host batches reach a card through two pinned buffers (``to_device``).
"""

import numpy as np
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


class PinnedUpload:
    """Host -> device copies of numpy batches through two pinned host
    buffers used in turn, with ``non_blocking=True``, as ``serve.py`` does
    for requests.  A buffer is refilled only after the event recorded
    behind its last copy has passed, so a batch is never overwritten while
    it is still being copied; a buffer grows when a batch does not fit.
    Not thread-safe: one thread uploads (the one that launches the work)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.slots = [None, None]   # (flat pinned buffer, event) or None
        self.turn = 0

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(batch))
        slot = self.slots[self.turn]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or slot[0].dtype != src.dtype or \
                slot[0].numel() < src.numel():
            slot = (torch.empty(src.numel(), dtype=src.dtype,
                                pin_memory=True), None)
        host = slot[0][:src.numel()].view(src.shape)
        host.copy_(src)   # torch's copy, several threads; numpy's is one
        x = host.to(self.dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.dev))
        self.slots[self.turn] = (slot[0], event)
        self.turn ^= 1
        return x


# device -> its PinnedUpload, kept so that no call allocates pinned memory
_uploads = {}


def to_device(batch, dev: torch.device) -> torch.Tensor:
    """A batch (numpy array or tensor) as a tensor on ``dev``: numpy
    batches go to a card through the device's ``PinnedUpload``, anything
    else through ``torch.as_tensor``."""
    if dev.type == "cuda" and isinstance(batch, np.ndarray):
        if dev not in _uploads:
            _uploads[dev] = PinnedUpload(dev)
        return _uploads[dev](batch)
    return torch.as_tensor(batch, device=dev)


def to_model_device(model: torch.nn.Module, x, device) -> torch.Tensor:
    """A model's input ``x`` on ``device`` (None = CUDA), which must be
    the device the model's parameters are on."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise UserError(f"the model is on {p.device}, the call asks for "
                        f"{dev}; move it with model.to(device)")
    return to_device(x, dev)
