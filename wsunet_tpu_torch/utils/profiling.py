"""Tracing and debugging aids (port of ``wsunet_tpu/utils/profiling.py``).

- ``profile(log_dir)``: ``torch.profiler`` over the CPU and, where there is
  a card, CUDA, writing a Chrome trace that TensorBoard's profiler plugin
  reads (``<log_dir>/<host>_<pid>.<time>.pt.trace.json``); every CLI
  command runs under it when ``WSUNET_PROFILE=<dir>`` is set.
- ``nan_check(enable)``: the counterpart of ``jax_debug_nans``.  While it
  is on, a dispatch mode checks the floating outputs of every op, forward
  and backward, and raises ``FloatingPointError`` at the op that made a
  NaN; anomaly detection names the forward op of a backward that did.
  The kernels B1 and B2 write through ctypes, where no dispatch mode sees
  them, so their wrappers check their own outputs (``check_output``).
  Off by default: the default path gets no check and no synchronisation.
  Every CLI command runs under it when ``WSUNET_DEBUG_NANS=1`` is set.
- ``log_compiles(enable)``: the port compiles only its CUDA kernels (one
  nvcc a source, ``ops/_cuda_build``); while it is on, each build is
  logged with its command and seconds.
"""

import contextlib
import logging
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

logger = logging.getLogger(__name__)

# whether nan_check / log_compiles are on (process-wide, as JAX's config
# flags are)
_state = {"nans": False, "compiles": False}

# ops whose output is uninitialised memory, which may hold any bits
_UNINITIALISED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                  torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                  torch.ops.aten.new_empty_strided, torch.ops.aten.resize_}


@contextlib.contextmanager
def profile(log_dir: str = None):
    """Trace host and device execution to ``log_dir`` (default
    ``$WSUNET_PROFILE``; nothing is traced when neither is set)."""
    log_dir = log_dir or os.environ.get("WSUNET_PROFILE")
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point() and
            t.device.type != "meta" and t.numel() > 0 and
            bool(torch.isnan(t).any()))


def check_output(t: torch.Tensor, producer: str) -> None:
    """Raise ``FloatingPointError`` if ``nan_check`` is on and ``t`` holds
    a NaN; ``producer`` names what wrote ``t`` (a kernel wrapper)."""
    if _state["nans"] and _has_nan(t):
        raise FloatingPointError(f"NaN in the output of {producer}")


class _NaNCheck(TorchDispatchMode):
    """Checks the floating outputs of every op dispatched under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED and \
                any(_has_nan(t) for t in tree_leaves(out)):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_check(enable: bool = True):
    """Raise ``FloatingPointError`` at the op (or kernel) whose output
    holds a NaN, in the forward and the backward."""
    if not enable:
        yield
        return
    old = _state["nans"]
    _state["nans"] = True
    try:
        with torch.autograd.detect_anomaly(check_nan=True), _NaNCheck():
            yield
    except RuntimeError as e:
        # a backward run where the dispatch mode did not reach (anomaly
        # detection's own check)
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(str(e)) from e
    finally:
        _state["nans"] = old


@contextlib.contextmanager
def log_compiles(enable: bool = True):
    """Log every nvcc build of the port's kernels while enabled."""
    old = _state["compiles"]
    _state["compiles"] = enable
    try:
        yield
    finally:
        _state["compiles"] = old


def note_compile(name: str, cmd, seconds: float) -> None:
    """Called by ``ops/_cuda_build`` after each build."""
    if _state["compiles"]:
        logger.warning("compiled %s in %.1f s: %s", name, seconds,
                       " ".join(map(str, cmd)))
