"""WS attack sweep over uint8 batches (port of the array part of
``wsunet_tpu/ws/estimate.py``).

The dispatch rule is the JAX package's: a named-filter attack without
bias correction, colour or the ``-sca`` score goes to the fused kernel
(there: Pallas on a TPU; here: the Triton kernel B2 on a CUDA batch);
everything else to ``ops.ws.ws_attack``.  The catalog/CSV ``run`` waits
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
    betas = []
    with torch.no_grad():
        for batch in batches:
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
