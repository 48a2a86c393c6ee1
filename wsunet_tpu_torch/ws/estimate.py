"""WS attack sweeps (port of ``wsunet_tpu/ws/estimate.py``).

- ``attack_batches``: beta_hat over an iterable of uint8 [B, H, W]
  batches (arrays or tensors).
- ``attack_sweep``: the same over catalog rows, fed by
  ``data.pipeline.sweep_batches``; a failed decode gives NaN.  Under a
  process group the sweep is rank-sharded (``parallel``): each rank
  attacks batches of its own strided rows, the fused route running B2
  once a batch on each rank, and every rank gets every row back in
  catalog order.  With
  ``channel`` (an [R, G, B, Y] plane other than Y) or ``pixel_estimator4``
  (the colour OLS predictor) it reads [B, H, W, 4] batches with
  ``io.imread4_u8`` and attacks the ``channel`` plane.
- ``run``: one (stego method, alpha, model) configuration, the rows of the
  ``ws-eval`` and ``roc`` sweeps (pandas at this edge only).  ``OLS``
  fits its taps on the covers (``ops.ols``): the 8-tap gray layout for
  one channel, color4 / color8 for two or three.

The dispatch rule is the JAX package's: a named-filter attack without
bias correction, colour or the ``-sca`` score goes to the fused kernel
(there: Pallas on a TPU; here: the CUDA kernel B2 on the card); the rest,
OLS included (B2 holds only the symmetric named filters), to
``ops.ws.ws_attack`` or ``ops.ws.ws_attack_sca`` (plain PyTorch, as they
are plain XLA in JAX).  On CUDA, numpy batches are uploaded through two
pinned host buffers (``_device.to_device``).
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..ops.filters import NAMED_FILTERS_2D
from ..ops.fused_ws import ws_attack_fused
from ..ops.ws import ws_attack, ws_attack_sca
from .unet_eval import get_unet_estimator


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


def _is_color(channel, pixel_estimator4) -> bool:
    return pixel_estimator4 is not None or channel not in (None, 3)


def _attack_step(dev: torch.device, pixel_kernel, pixel_estimator,
                 kernel_name, weighted, correct_bias, sca, channel=None,
                 pixel_estimator4=None) -> typing.Callable:
    """The per-batch step: a uint8 batch -> beta_hat [B] on ``dev``; a
    colour step takes [B, H, W, 4] batches, planes [R, G, B, Y]."""
    if kernel_name is not None and pixel_kernel is None:
        pixel_kernel = NAMED_FILTERS_2D[kernel_name]
    color = _is_color(channel, pixel_estimator4)
    use_fused = (kernel_name is not None and not correct_bias and not sca
                 and not color and dev.type == "cuda")
    if pixel_estimator4 is not None and correct_bias:
        raise NotImplementedError(
            "bias correction with a multi-channel predictor")
    plane = 3 if channel is None else channel

    def step(batch) -> torch.Tensor:
        x = to_device(batch, dev)
        if color:
            x4 = x.permute(0, 3, 1, 2)
            x = x4[:, plane]
            if pixel_estimator4 is not None:
                x_hat = pixel_estimator4(x4.to(torch.float32))
                return ws_attack(x, pixel_estimator=lambda _: x_hat,
                                 weighted=weighted)
        elif x.ndim != 3:
            raise ValueError(
                f"expected uint8 [B, H, W] batches, got {tuple(x.shape)}")
        if use_fused:
            return ws_attack_fused(x.contiguous(), kernel_name,
                                   weighted=weighted)
        if sca:
            return ws_attack_sca(x, pixel_kernel=pixel_kernel,
                                 pixel_estimator=pixel_estimator)
        return ws_attack(x, pixel_kernel=pixel_kernel,
                         pixel_estimator=pixel_estimator,
                         weighted=weighted, correct_bias=correct_bias)

    return step


def attack_batches(
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
    -> [B, H-2, W-2]) set any other predictor; ``sca`` takes the
    selection-channel-aware score."""
    step = _attack_step(resolve_device(device), pixel_kernel,
                        pixel_estimator, kernel_name, weighted, correct_bias,
                        sca)
    with torch.no_grad():
        betas = [step(batch) for batch in batches]
    if not betas:
        return np.array([])
    return torch.cat(betas).cpu().numpy().astype("float64")


def attack_sweep(
    root: pathlib.Path,
    df,
    pixel_kernel=None,
    pixel_estimator: typing.Callable = None,
    kernel_name: str = None,
    weighted: int = 0,
    correct_bias: bool = False,
    batch_size: int = 8,
    threads: int = 8,
    channel: int = None,
    pixel_estimator4: typing.Callable = None,
    sca: bool = False,
    device=None,
) -> np.ndarray:
    """beta_hat (float64) for every catalog row of ``df`` (anything with a
    ``name`` column), in order; NaN where the image failed to decode.
    ``channel`` picks an [R, G, B, Y] plane (None or 3: the luminance);
    ``pixel_estimator4`` (f32 [B, 4, H, W] -> [B, H-2, W-2]) predicts the
    ``channel`` plane from all four.  Under a process group each rank
    sweeps batches of ``batch_size`` of its own rows (``batch_size`` is
    per rank) and returns every row."""
    from ..data.pipeline import sweep_batches
    from ..io.imread import imread4_u8, imread_gray_u8

    step = _attack_step(resolve_device(device), pixel_kernel,
                        pixel_estimator, kernel_name, weighted, correct_bias,
                        sca, channel, pixel_estimator4)
    reader = imread4_u8 if _is_color(channel, pixel_estimator4) \
        else imread_gray_u8
    # roc runs this once per (model, method, alpha) over the same images;
    # each is decoded once
    with torch.no_grad():
        return sweep_batches(root, list(df["name"]),
                             lambda px: (step(px),), batch_size,
                             threads=threads, reader=reader).reshape(-1)


def _fit_ols(input_dir, channels, split, dev):
    """OLS fitted on the covers of ``split`` (all covers when None), on
    ``dev``: (3x3 kernel, None) in the gray layout (one channel: the taps
    are fitted on the luminance, as in JAX), (None, estimator4) in the
    color4 / color8 layout (two or three channels)."""
    from ..data.catalog import precovers
    from ..data.pipeline import load_images
    from ..io.imread import imread4_u8
    from ..ops.ols import ols_color_kernels, ols_color_predict, ols_kernel2d

    names = list(precovers(input_dir, split=split)["name"])
    if len(channels) > 1:
        x4 = torch.as_tensor(load_images(input_dir, names, reader=imread4_u8),
                             device=dev).permute(0, 3, 1, 2)
        kernels = ols_color_kernels(x4, channels)
        return None, lambda v: ols_color_predict(v, kernels)
    pixels = torch.as_tensor(load_images(input_dir, names), device=dev)
    # ols_kernel2d is a correlation kernel; filter_predict applies a true
    # convolution, so flip it (the fit, unlike the named filters, is not
    # symmetric)
    return ols_kernel2d(pixels)[::-1, ::-1], None


def run(
    input_dir: pathlib.Path,
    stego_method: str,
    alpha: float,
    model_name: str,
    model_path: pathlib.Path = None,
    channels: typing.Tuple[int, ...] = (3,),
    weighted: int = 0,
    correct_bias: bool = False,
    batch_size: int = 8,
    threads: int = 8,
    split: str = None,
    take_num_images: int = None,
    model_label: str = None,
    ols_fit_split: str = None,
    fast_conv=False,
    device=None,
):
    """One (stego_method, alpha, model) attack configuration: the selected
    rows with beta_hat, model_name, channels, weighted and correct_bias
    (rows whose image failed to decode are dropped).  ``model_name`` is a
    named filter, ``<FILTER>-w``, ``<FILTER>-sca``, ``OLS`` (fitted on
    the covers of ``ols_fit_split``, all covers by default), or a trained
    U-Net run under ``model_path`` (labelled "UNet"); ``model_label``
    overrides the model_name column.  ``channels`` are [R, G, B, Y]
    planes, the attacked one last; two or three pick OLS's color4 /
    color8 layout.  ``stego_method`` None selects the covers;
    ``fast_conv=True`` runs a U-Net's 3x3 convs through kernel B1."""
    from ..data.catalog import precovers, stego_spatial

    dev = resolve_device(device)
    channel = tuple(channels)[-1] if channels else 3
    kernel_name, estimator, kernel, estimator4 = None, None, None, None
    weighted_label = None
    sca = False
    if model_name.endswith("-w") and model_name[:-2] in NAMED_FILTERS_2D:
        weighted_label, model_name, weighted = model_name, model_name[:-2], 1
    if model_name.endswith("-sca") and model_name[:-4] in NAMED_FILTERS_2D:
        weighted_label, model_name, sca = model_name, model_name[:-4], True
    if model_name in NAMED_FILTERS_2D:
        kernel, kernel_name = NAMED_FILTERS_2D[model_name], model_name
        out_model_name = model_name
    elif model_name == "OLS":
        kernel, estimator4 = _fit_ols(input_dir, channels, ols_fit_split,
                                      dev)
        out_model_name = "OLS"
    else:
        estimator = get_unet_estimator(model_path, model_name,
                                       fast_conv=fast_conv, device=device)
        out_model_name = "UNet"

    select = dict(split=split, take_num_images=take_num_images)
    if stego_method:
        df = stego_spatial(input_dir, stego_method=stego_method, alpha=alpha,
                           **select)
    else:
        df = precovers(input_dir, **select)

    betas = attack_sweep(
        input_dir, df, pixel_kernel=kernel, pixel_estimator=estimator,
        kernel_name=kernel_name, weighted=weighted,
        correct_bias=correct_bias, batch_size=batch_size, threads=threads,
        channel=channel, pixel_estimator4=estimator4, sca=sca, device=dev)

    res = df.reset_index(drop=True).copy()
    res["beta_hat"] = betas
    res["model_name"] = model_label or weighted_label or out_model_name
    res["channels"] = "".join(map(str, channels))
    # -sca rows stamp weighted and correct_bias values the score ignores,
    # as the JAX package's do
    res["weighted"] = weighted
    res["correct_bias"] = correct_bias
    return res[~res.beta_hat.isna()]
