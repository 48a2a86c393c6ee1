"""WS attack sweep over uint8 batches (port of the array part of
``wsunet_tpu/ws/estimate.py``).

The dispatch rule is the JAX package's: a named-filter attack without
bias correction, colour or the ``-sca`` score goes to the fused kernel
(there: Pallas on a TPU; here: the CUDA kernel B2 on a CUDA batch);
everything else to ``ops.ws.ws_attack``.  On CUDA, numpy batches are
uploaded through two pinned host buffers, kept per device from call to
call (``_PinnedUpload``).  The catalog/CSV ``run`` waits
for the data-module slice; colour batches ([B, H, W, 4], the colour OLS
predictor) and ``-sca`` (HILL costs) wait for the slices that port them.
"""

import typing

import numpy as np
import torch

from .._device import resolve_device
from ..ops.filters import NAMED_FILTERS_2D
from ..ops.fused_ws import ws_attack_fused
from ..ops.ws import ws_attack


def parse_filter_model(model_name: str) -> typing.Tuple[str, int, bool]:
    """``"KB"`` -> ("KB", 0, False); ``"<FILTER>-w"`` -> the
    inverse-variance weighted estimate (weighted=1); ``"<FILTER>-sca"`` ->
    the selection-channel-aware score.  Other names pass through with
    weighted=0."""
    if model_name.endswith("-w") and model_name[:-2] in NAMED_FILTERS_2D:
        return model_name[:-2], 1, False
    if model_name.endswith("-sca") and model_name[:-4] in NAMED_FILTERS_2D:
        return model_name[:-4], 0, True
    return model_name, 0, False


class _PinnedUpload:
    """Host -> device copies of numpy batches through two pinned host
    buffers used in turn, with ``non_blocking=True``, as ``serve.py`` does
    for requests.  A buffer is refilled only after the event recorded
    behind its last copy has passed, so a batch is never overwritten while
    it is still being copied; a buffer grows when a batch does not fit."""

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


# device -> its _PinnedUpload, kept so that no call allocates pinned memory
_uploads = {}


def attack_sweep(
    batches: typing.Iterable,
    pixel_kernel=None,
    pixel_estimator: typing.Callable = None,
    kernel_name: str = None,
    weighted: int = 0,
    correct_bias: bool = False,
    sca: bool = False,
    device=None,
) -> np.ndarray:
    """beta_hat (float64) for every image of ``batches``, an iterable of
    uint8 [B, H, W] arrays or tensors, computed on ``device`` (None =
    CUDA).  ``kernel_name`` names a filter of ``NAMED_FILTERS_2D``;
    ``pixel_kernel`` (a 3x3 array) or ``pixel_estimator`` (f32 [B, H, W]
    -> [B, H-2, W-2]) set any other predictor."""
    if sca:
        raise NotImplementedError(
            "the -sca score (HILL costs) is not ported yet")
    dev = resolve_device(device)
    if kernel_name is not None and pixel_kernel is None:
        pixel_kernel = NAMED_FILTERS_2D[kernel_name]
    use_fused = (kernel_name is not None and not correct_bias and
                 dev.type == "cuda")
    upload = None
    if dev.type == "cuda":
        upload = _uploads.setdefault(dev, _PinnedUpload(dev))
    betas = []
    with torch.no_grad():
        for batch in batches:
            if upload is not None and isinstance(batch, np.ndarray):
                x = upload(batch)
            else:
                x = torch.as_tensor(batch, device=dev)
            if x.ndim != 3:
                raise ValueError(
                    f"expected uint8 [B, H, W] batches, got {tuple(x.shape)}")
            if use_fused:
                b = ws_attack_fused(x.contiguous(), kernel_name,
                                    weighted=weighted)
            else:
                b = ws_attack(x, pixel_kernel=pixel_kernel,
                              pixel_estimator=pixel_estimator,
                              weighted=weighted, correct_bias=correct_bias)
            betas.append(b)
    if not betas:
        return np.array([])
    return torch.cat(betas).cpu().numpy().astype("float64")
