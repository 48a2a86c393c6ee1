"""Row-sharded WS attack and U-Net with halo exchange (port of
``wsunet_tpu/parallel/spatial.py``).

The scale-out path for images too large for one device: the image rows
are split over the ranks of a mesh, each rank keeps ``H / world`` rows,
and the rows a 3x3 window needs from beyond its block come from its
neighbours.  Each exchange all-gathers the first and last row of every
rank (a few rows, on every backend; JAX sends them round the ring with
``ppermute``), so it runs at a world of one too, as ``shard_map`` does.

- ``ws_attack_spatial``: the halo-exchanged filter WS attack of JAX's
  ``shard_map`` program: the 3x3 prediction and WS contribution of the
  rank's rows (global rows 0 and H-1 masked), numerator and denominator
  summed over the ranks.  Its convs are plain PyTorch, as JAX computes
  them with XLA convs outside any Pallas kernel.
- ``infer_unet_spatial``: U-Net inference on row blocks.  JAX gets it from
  GSPMD's automatic partitioning; here the model's own forward runs on
  the rank's rows with a halo exchange as the padding of each of its
  reflect-padded 3x3 convs (``UNet.forward``'s ``pad``): a fresh one-row
  halo, the neighbour's boundary row inside the image and the reflected
  row (row 1, row H-2) at its top and bottom.  Columns are reflect-padded
  locally and a valid conv follows; pooling, the transposed convs, the
  skips and the 1x1 head are local.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .._device import to_device
from ..data.transforms import center_crop
from ..ops.filters import NAMED_FILTERS_2D, conv2d_valid
from ..utils.errors import UserError
from .mesh import Mesh, get_mesh


def _boundary_rows(mesh: Mesh, x: torch.Tensor) -> list:
    """[first row, last row] of every rank's block of ``x`` [..., h, W],
    in rank order: one all-gather."""
    return mesh.all_gather(torch.stack([x[..., 0, :], x[..., -1, :]]))


def ws_attack_spatial(x_u8, kernel, mesh: Mesh = None, axis: str = "data",
                      weighted: int = 0) -> torch.Tensor:
    """WS attack with the image rows sharded over ``mesh`` (None: the
    ranks of the process group, or this process alone).

    x_u8: the full [B, H, W] uint8 batch on every rank, H divisible by the
    world size.  Returns beta_hat [B], clipped at 0, on every rank; the
    work runs on ``x_u8``'s device."""
    mesh = get_mesh(axis=axis) if mesh is None else mesh
    x_u8 = torch.as_tensor(x_u8)
    B, H, W = x_u8.shape
    if H % mesh.world:
        raise UserError(f"{H} rows do not divide over {mesh.world} ranks")
    k = np.asarray(kernel, dtype="float32")[::-1, ::-1]
    rows = mesh.block(H)
    blk = x_u8[:, rows]
    # ring halo: the last row of the rank above, the first of the rank
    # below (wrapping round, as JAX's ppermute does; the wrapped rows only
    # reach the masked global rows 0 and H-1)
    every = _boundary_rows(mesh, blk)
    above = every[(mesh.rank - 1) % mesh.world][1]
    below = every[(mesh.rank + 1) % mesh.world][0]
    x = blk.to(torch.float32)
    x_ext = torch.cat([above[:, None], blk, below[:, None]], dim=1).to(
        torch.float32)
    x_hat = conv2d_valid(x_ext, k)
    x_own = x[:, :, 1:-1]
    sign = 2.0 * (x_own - 2.0 * torch.floor(x_own * 0.5)) - 1.0
    g = torch.arange(rows.start, rows.stop, device=x.device)
    row_mask = ((g >= 1) & (g < H - 1)).to(torch.float32)[:, None]
    contrib = sign * (x_own - x_hat) * row_mask
    if weighted == 0:
        n = (H - 2) * (W - 2)
        beta = mesh.all_reduce(torch.sum(contrib, dim=(1, 2)) / n)
    else:
        avg = np.asarray(NAMED_FILTERS_2D["AVG"])[::-1, ::-1]
        mu = conv2d_valid(x_ext, avg)
        mu2 = conv2d_valid(x_ext * x_ext, avg)
        var = mu2 - mu * mu
        w = 1.0 / (5.0 + var) if weighted == 1 else (5.0 + var)
        w = w * row_mask
        num, den = mesh.all_reduce(torch.stack([
            torch.sum(contrib * w, dim=(1, 2)), torch.sum(w, dim=(1, 2))]))
        beta = num / den
    return torch.clamp(beta, min=0.0)


def _halo_pad(mesh: Mesh):
    """The padding of a 3x3 conv on this rank's rows [..., h, W] of an
    activation split over ``mesh`` (``models.unet.UNet.forward``'s
    ``pad``): the row above and the row below come from the neighbours,
    or are the reflected rows (row 1, row H-2) at the image's top and
    bottom; the columns are reflect-padded."""

    def pad(x: torch.Tensor) -> torch.Tensor:
        every = _boundary_rows(mesh, x)
        r, n = mesh.rank, mesh.world
        h = x.shape[-2]
        if r > 0:
            above = every[r - 1][1]
        else:   # global row 1
            above = x[..., 1, :] if h > 1 else every[1][0]
        if r < n - 1:
            below = every[r + 1][0]
        else:   # global row H-2
            below = x[..., h - 2, :] if h > 1 else every[n - 2][1]
        x = torch.cat([above[..., None, :], x, below[..., None, :]], dim=-2)
        return F.pad(x, (1, 1, 0, 0), mode="reflect")

    return pad


@torch.no_grad()
def infer_unet_spatial(model, x, mesh: Mesh = None,
                       axis: str = "data") -> torch.Tensor:
    """``ws.unet_eval.infer_unet`` with the image rows split over ``mesh``
    (None: the ranks of the process group, or this process alone).

    x: the full [B, H, W] f32 pixels (0..255) on every rank, taken to the
    model's device; returns the full [B, H-2, W-2] prediction (0..255) on
    every rank.  After the 512 center crop, ``H / world`` must divide by
    ``2 ** nsteps`` (the pooled rows stay whole on each rank).  Only the
    default conv route is sharded: B1 (``fast_conv=True``) and
    ``"borderfix"`` pad at their own tile edges, so a model on either
    raises ``UserError``."""
    if model.fast_conv is not False:
        raise UserError(f"infer_unet_spatial runs the default conv route; "
                        f"the model has fast_conv={model.fast_conv!r}")
    mesh = get_mesh(axis=axis) if mesh is None else mesh
    dev = next(model.parameters()).device
    x = center_crop(to_device(x, dev).to(torch.float32), 512)
    H = x.shape[1]
    step = mesh.world * 2 ** model.nsteps
    if H % step:
        raise UserError(f"{H} rows over {mesh.world} ranks: the rows of a "
                        f"rank must divide by 2**{model.nsteps}")
    y = model(x[:, None, mesh.block(H)] / 255.0, pad=_halo_pad(mesh))
    full = torch.cat(mesh.all_gather(y[:, 0]), dim=1)
    return full[:, 1:-1, 1:-1].to(torch.float32) * 255.0
