"""Rank-parallel runtime on ``torch.distributed`` (port of
``wsunet_tpu/parallel``): the 1-D mesh of ranks (``mesh``), the process
group (``distributed``), the rank-sharded eval sweeps (``eval_shard``)
and the halo-exchanged spatial paths (``spatial``)."""

from .mesh import get_mesh, shard_batch, replicate, device_count
from .eval_shard import (
    allgather_rows, batch_sharding, cache_on_device, eval_device_count,
    fetch_rows, host_shard, jit_sharded, place, round_batch,
    set_eval_devices)

__all__ = ["get_mesh", "shard_batch", "replicate", "device_count",
           "allgather_rows", "batch_sharding", "cache_on_device",
           "eval_device_count", "fetch_rows", "host_shard", "jit_sharded",
           "place", "round_batch", "set_eval_devices"]
