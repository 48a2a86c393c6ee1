"""Filter prediction-error evaluation, MAE and HILL-weighted MAE (port of
``wsunet_tpu/ws/filters_eval.py``).

Per cover image and named filter: the residual of the 9-tap prediction
(``ops.filter_residuals``), its mean absolute value (MAE), and its mean
over the pixels whose HILL cost lies at or below the image's 0.1 quantile
(wMAE), in the ``results/prediction/filters.csv`` schema.

- ``channel`` 3 reads the luminance plane alone (``imread_gray_u8``);
  channels 0-2 read the [R, G, B, Y] stack (``imread4_u8``) and take that
  plane.
- ``inbayer`` ("00", "01", "10", "11") subsamples the residual and cost
  maps on the Bayer grid (``bayer_slices``).
- The decile is numpy's linear rule computed as ``jnp.quantile`` computes
  it in f32 (``quantile_linear``), from two order statistics per row
  (``torch.kthvalue``), so no batch size runs into a size limit of
  ``torch.quantile``.

``mae_wmae`` is the device step (numpy and torch only, so it runs on the
card); ``filters_sweep`` runs it over image names through the batched
pipeline and the plane's reader; ``run`` gives the CSV's rows as a table
(``utils.table``).
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..io.imread import imread4_u8, imread_gray_u8
from ..ops.filters import NAMED_FILTERS, filter_residuals, taps_to_kernel2d
from ..ops.hill import hill_cost
from ..utils.table import Table, concat


def bayer_slices(inbayer: str):
    """Valid-grid slices of the reference's Bayer-phase subsample: a phase
    digit '0' keeps rows (columns) 2, 4, ... of the image, which is
    [1:-1:2] of the [H-2, W-2] residual grid; '1' keeps 1, 3, ..., which
    is [::2]."""
    if not inbayer:
        return slice(None), slice(None)

    def ax(digit):
        return slice(1, -1, 2) if digit == "0" else slice(None, None, 2)

    return ax(inbayer[0]), ax(inbayer[1])


def quantile_linear(v: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row ``q`` quantile of [B, N] by numpy's linear rule, in the f32
    arithmetic of ``jnp.quantile``: position f32(q) * (N - 1), the order
    statistics at its floor and ceiling, weights 1 - w and w with w the
    position's fraction."""
    n = v.shape[1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    v_lo = torch.kthvalue(v, lo + 1, dim=1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(v, hi + 1, dim=1).values
    return v_lo * float(w_lo) + v_hi * float(w_hi)


def mae_wmae(pixels: torch.Tensor, kernel2d, channel: int = None,
             inbayer: str = None) -> tuple:
    """(MAE, wMAE) [B] f32 of a pixel batch, [B, H, W] or [B, H, W, 4]
    (plane ``channel``, default 3), on the batch's device."""
    x = pixels.to(torch.float32)
    if x.ndim == 4:
        x = x[..., 3 if channel is None else channel]
    s1, s2 = bayer_slices(inbayer)
    resid = torch.abs(filter_residuals(x, kernel2d))[:, s1, s2]
    mae = resid.mean(dim=(1, 2))
    rho = hill_cost(x, wet_cost=1e10)[:, 1:-1, 1:-1][:, s1, s2]
    q = quantile_linear(rho.reshape(rho.shape[0], -1), 0.1)
    sel = rho <= q[:, None, None]
    wmae = (torch.sum(resid * sel, dim=(1, 2)) /
            torch.sum(sel, dim=(1, 2)))
    return mae, wmae


def filters_sweep(root, names, filter_name: str, channel: int = 3,
                  inbayer: str = None, batch_size: int = 8,
                  threads: int = 8, device=None) -> np.ndarray:
    """(MAE, wMAE) float64 [len(names), 2] of the images ``names`` under
    ``root`` for one named filter and plane, on ``device`` (None = CUDA),
    NaN rows where an image failed to decode.  Batches stay on the device
    after their first pass (``device_cache``)."""
    from ..data.pipeline import sweep_batches

    dev = resolve_device(device)
    kernel2d = taps_to_kernel2d(NAMED_FILTERS[filter_name])

    def step(px):
        return mae_wmae(to_device(px, dev), kernel2d, channel=channel,
                        inbayer=inbayer)

    return sweep_batches(root, names, step, batch_size, threads=threads,
                         device_cache=True, device=dev,
                         reader=imread_gray_u8 if channel == 3
                         else imread4_u8)


def run(input_dir: pathlib.Path,
        filter_names: typing.Sequence[str] = ("AVG", "KB"),
        channels: typing.Sequence[typing.Tuple[int, ...]] = ((3,), (3,)),
        inbayer: str = None, batch_size: int = 8, threads: int = 8,
        split: str = None, device=None, **order_kw):
    """Every (filter, channel) pair over the catalog's covers: one table
    of rows ``fname``, ``mae_<c>_<filter>``, ``wmae_<c>_<filter>`` (f32)
    and the catalog row per pair, concatenated in the JAX package's order;
    an image that fails to decode has no row."""
    from ..data.catalog import precovers

    resolve_device(device)
    frames = []
    for channel, filter_name in zip(channels, filter_names):
        cname = "".join(map(str, channel))
        df = precovers(input_dir, split=split, **order_kw)
        vals = filters_sweep(input_dir, list(df["name"]), filter_name,
                             channel=channel[0], inbayer=inbayer,
                             batch_size=batch_size, threads=threads,
                             device=device)
        ok = ~np.isnan(vals[:, 0]) if len(df) else np.zeros(0, bool)
        rows = df[ok]
        out = Table({"fname": [str(pathlib.Path(input_dir) / name)
                               for name in rows["name"]]}, n=len(rows))
        if len(rows):
            out[f"mae_{cname}_{filter_name}"] = \
                vals[ok, 0].astype(np.float32)
            out[f"wmae_{cname}_{filter_name}"] = \
                vals[ok, 1].astype(np.float32)
            for name in rows.columns:
                out[name] = rows[name]
        frames.append(out)
    return concat(frames)
