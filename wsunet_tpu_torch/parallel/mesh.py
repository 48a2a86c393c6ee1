"""The 1-D mesh of ranks and its batch helpers (port of
``wsunet_tpu/parallel/mesh.py``).

In the JAX package a 1-D ``data`` mesh shards the batch axis over the
devices of one program, parameters are replicated, and XLA inserts the
collectives.  Here every rank is a process with one device: ``Mesh``
holds the process group, this rank and the world size, and carries the
collectives that the port's parallel paths call by hand.  It is a small
object, not ``torch.distributed.device_mesh``: a device mesh needs a
process group, and the port's world of one has none.

Without a process group ``get_mesh`` gives a world of one on the current
process: every collective is then the identity and nothing is
initialised, so single-process code runs exactly as it did.  The test
hook ``eval_shard.set_eval_devices(1)`` gives the same inside a group.
"""

import dataclasses
import typing

import numpy as np
import torch
import torch.distributed as dist

from ..utils.errors import UserError


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of ``group`` (None: this process alone,
    a world of one).  ``axis`` names the mesh axis, as in JAX;
    ``host_to`` is where a payload made on the host goes for the
    collectives (the card under nccl, else the host)."""

    group: typing.Any = None
    rank: int = 0
    world: int = 1
    axis: str = "data"
    host_to: torch.device = torch.device("cpu")

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of length ``n`` (what
        ``P("data")`` gives device ``rank``); ``n`` must divide by the
        world size."""
        if n % self.world:
            raise UserError(f"a batch axis of {n} does not divide over "
                            f"{self.world} ranks")
        size = n // self.world
        return slice(self.rank * size, (self.rank + 1) * size)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor on ``t``'s
        device (no gradient)."""
        out = t.detach().clone()
        if self.group is not None:
            dist.all_reduce(out, group=self.group)
        return out

    def all_reduce_autograd(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks with its gradient: the backward
        sums each rank's gradient of the result, so the gradient that
        reaches ``t`` is that of the sum of every rank's objective."""
        if self.group is None:
            return t
        return _RankSum.apply(t, self)

    def all_gather(self, t: torch.Tensor) -> typing.List[torch.Tensor]:
        """``t`` of every rank, in rank order, on ``t``'s device; every
        rank's ``t`` has the same shape and dtype."""
        if self.group is None:
            return [t]
        t = t.detach().contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.group)
        return out

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of a batch, concatenated in rank order along
        the leading axis: the global batch."""
        if self.group is None:
            return t
        return torch.cat(self.all_gather(t))

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` in place with rank ``src``'s."""
        if self.group is not None:
            dist.broadcast(t.detach(), src=src, group=self.group)
        return t

    def broadcast_object(self, obj, src: int = 0):
        """A picklable value of rank ``src``, on every rank."""
        if self.group is None:
            return obj
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def sum_gradients(self, module: torch.nn.Module) -> None:
        """Replace every parameter gradient of ``module`` by its sum over
        the ranks (one all-reduce of the gradients laid end to end)."""
        if self.group is None:
            return
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        total = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        parts = total.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [v.view_as(g)
                                     for v, g in zip(parts, grads)])

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


class _RankSum(torch.autograd.Function):
    """``Mesh.all_reduce`` with its gradient: the backward is the sum over
    the ranks of the incoming gradients.  Its node runs on the device of
    its input, so every rank's backward reaches its collectives in the
    same order."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad), None


def device_count() -> int:
    """The devices the mesh spans: one a rank, so the world size of the
    process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_mesh(n_devices: int = None, axis: str = "data") -> Mesh:
    """1-D mesh over the ranks of the process group (all by default).
    ``n_devices=1`` is this process alone, whatever group is up (the
    test hook ``eval_shard.set_eval_devices(1)``); any other count must
    be the world size."""
    if not dist.is_initialized() or n_devices == 1:
        return Mesh(axis=axis)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise UserError(f"a mesh of {n_devices} devices, but the process "
                        f"group has {world} ranks")
    host_to = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), world=world,
                axis=axis, host_to=host_to)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's contiguous block of the leading (batch) axis of every
    array or tensor of ``batch`` (a nested dict, list or tuple of them).
    Batch sizes must divide by the mesh size."""

    def take(x):
        return x[mesh.block(x.shape[0])]

    return _tree_map(take, batch)


def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank: each parameter and buffer of a
    module, or each tensor or array of a nested dict, list or tuple, is
    overwritten in place by rank 0's; other leaves are sent whole."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                mesh.broadcast_(t.data)
        return tree

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return mesh.broadcast_(x)
        if isinstance(x, np.ndarray):
            t = mesh.broadcast_(torch.from_numpy(x).to(mesh.host_to))
            x[...] = t.cpu().numpy()
            return x
        return mesh.broadcast_object(x)

    return _tree_map(leaf, tree)
