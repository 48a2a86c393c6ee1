"""Process-group runtime (port of ``wsunet_tpu/parallel/distributed.py``).

The JAX package brings up ``jax.distributed`` under a multi-process
launcher and feeds each host's rows into global arrays; the port starts a
``torch.distributed`` process group, one rank a device, and each rank
feeds its own batches.

- ``distributed_init``: the group from ``torchrun``'s environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) or
  from explicit arguments; a no-op at one process.
- ``process_local_rows``: this rank's strided rows of a catalog.

The collectives (``mesh.Mesh``) take each payload where it lies.  nccl
needs it on the card; gloo takes host and CUDA tensors alike (it copies a
CUDA payload through the host itself; all_reduce, broadcast and
all_gather of CUDA tensors are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 14), so two gloo
ranks sharing one card pass their CUDA tensors as they are.
"""

import os

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..utils.errors import UserError
from ..utils.table import Table


def distributed_init(init_method: str = None, world_size: int = None,
                     rank: int = None, backend: str = None,
                     device=None) -> bool:
    """Start the process group of this rank; return True when more than
    one process takes part.

    Without explicit arguments the group comes from ``torchrun``'s
    environment; without that environment, or with ``WORLD_SIZE`` 1, this
    is a no-op that returns False, as the JAX package's is at one process.
    ``init_method`` (``file://...`` or ``tcp://host:port``), ``world_size``
    and ``rank`` start a group without the environment, a world of one
    included.  ``device`` is the device the rank computes on (None =
    CUDA); a CUDA rank takes card ``LOCAL_RANK % device_count``.  The
    backend is ``nccl`` for CUDA ranks and ``gloo`` for CPU ranks unless
    ``backend`` names one (``gloo`` on CUDA ranks, as two ranks sharing
    one card need: nccl refuses two ranks on one card).  ``nccl`` without
    a card raises ``UserError``; nothing falls back to the CPU.  A group
    that is already up is kept."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(v is not None for v in (init_method, world_size, rank))
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not explicit and ("RANK" not in os.environ or env_world == 1):
        return False
    if backend == "nccl" and not torch.cuda.is_available():
        raise UserError("the nccl backend needs a CUDA card; none is "
                        "available")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise UserError(f"the nccl backend needs CUDA ranks, not {dev}")
    world_size = env_world if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1


def process_local_rows(names_or_df, rank: int = None, world: int = None):
    """This rank's strided rows ``rank::world`` of a list of names or a
    catalog table (each rank decodes only its own rows)."""
    if rank is None or world is None:
        active = dist.is_initialized()
        rank = (dist.get_rank() if active else 0) if rank is None else rank
        world = (dist.get_world_size() if active else 1) \
            if world is None else world
    if isinstance(names_or_df, Table):
        return names_or_df[rank::world]
    return list(names_or_df)[rank::world]
