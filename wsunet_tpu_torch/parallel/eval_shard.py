"""Rank-sharded evaluation sweeps (port of
``wsunet_tpu/parallel/eval_shard.py``).

The JAX package compiles every eval step with its batch axis sharded over
a 1-D device mesh, and under several processes each host feeds its
strided rows and the per-image scalars are all-gathered back into catalog
order.  Here every rank is a process with one device, so the
multi-process route is the only one: each rank takes its strided rows of
the catalog (``host_shard``), runs the step on its own batches, and the
per-image rows are all-gathered (``allgather_rows``).  The sweeps' math is
per image, so a rank-sharded sweep gives the one-process rows bit for
bit.  Every sweep goes through ``data.pipeline.sweep_batches``, which
calls these helpers; at a world of one each of them is the identity.

``batch_size`` is per rank: each rank runs batches of ``batch_size`` of
its own rows.  In the JAX package ``batch_size`` is the global batch of
one program, split over the mesh's devices (so ``round_batch`` rounds it
up to a multiple of the device count); under its multi-process runtime
each host feeds ``batch_size`` rows, assembled into one global array.
"""

import numpy as np
import torch

from .._device import resolve_device, to_device
from .mesh import Mesh, get_mesh

# test hook: 1 makes this rank run the whole catalog alone (the
# counterpart of JAX's 1-device mesh), whatever process group is up
_FORCE_DEVICES = None


def set_eval_devices(n):
    """Limit eval sweeps to ``n`` ranks: 1 runs the catalog on this rank
    alone, None on every rank of the group.  Testing hook; also pins a
    sweep to one process of a group."""
    global _FORCE_DEVICES
    _FORCE_DEVICES = n


def eval_mesh() -> Mesh:
    return get_mesh(_FORCE_DEVICES)


def eval_device_count() -> int:
    return eval_mesh().world


def host_shard(names):
    """(local_rows, n_true): this rank's strided rows of ``names`` (a list
    of names or a catalog frame), padded by repeating the first row so
    that every rank takes the same number of steps.  ``n_true`` is the
    unpadded count; rows computed for the padding are dropped before
    ``allgather_rows``.  At a world of one: (names, len(names))."""
    mesh = eval_mesh()
    if mesh.world == 1:
        return names, len(names)
    from .distributed import process_local_rows
    local = process_local_rows(names, mesh.rank, mesh.world)
    n_true = len(local)
    target = -(-len(names) // mesh.world)
    if n_true < target and len(names):
        if hasattr(names, "iloc"):
            import pandas as pd
            local = pd.concat([local] + [names.iloc[[0]]] *
                              (target - n_true))
        else:
            local = local + [names[0]] * (target - n_true)
    return local, n_true


def cache_on_device() -> bool:
    """The device cache of batches is a single-process optimisation, as
    in JAX: under ranks the sweeps disable it."""
    return eval_mesh().world == 1


def allgather_rows(values: np.ndarray, n_total: int) -> np.ndarray:
    """Sweep reassembly: each rank computed ``values`` (rows along the
    leading axis) for its strided rows ``rank::world`` of a
    ``n_total``-row catalog; return every row in catalog order on every
    rank.  The rows travel as float64, padded with NaN to the same count
    on every rank, so a sharded sweep keeps the one-process values bit for
    bit.  At a world of one ``values`` itself."""
    mesh = eval_mesh()
    if mesh.world == 1:
        return values
    values = np.asarray(values)
    pad = -(-n_total // mesh.world)
    buf = np.full((pad,) + values.shape[1:], np.nan, np.float64)
    buf[:len(values)] = values
    gathered = [g.cpu().numpy() for g in mesh.all_gather(
        torch.from_numpy(buf).to(mesh.host_to))]
    out = np.full((n_total,) + values.shape[1:], np.nan, values.dtype)
    for r in range(mesh.world):
        rows = np.arange(r, n_total, mesh.world)
        out[rows] = gathered[r][:len(rows)]
    return out


# JAX's names in ``parallel.__all__`` whose work the port's one device a
# rank makes trivial; the sweeps do without them, callers written for the
# JAX package keep working

def round_batch(batch_size: int) -> int:
    """The batch each rank runs: ``batch_size`` itself (in JAX a multiple
    of the mesh size, split over its devices)."""
    return int(batch_size)


def batch_sharding() -> Mesh:
    """How the batch axis is split: over the ranks of the eval mesh."""
    return eval_mesh()


def place(pixels, device=None) -> torch.Tensor:
    """A host batch (this rank's part of the global batch) as a tensor on
    ``device`` (None = CUDA)."""
    return to_device(pixels, resolve_device(device))


def fetch_rows(out) -> np.ndarray:
    """A step's per-image outputs as numpy, this rank's rows in order."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def jit_sharded(step):
    """``step`` itself: each rank runs the sweep's per-image step on its
    own batch, with no collective inside (JAX compiles it for its
    mesh)."""
    return step
