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
- ``span(name)``, ``count(name, n)``: the program's own spans and counters
  on its hot path (``Recorder``), kept in memory while a torch profiler
  runs on the thread that drives the program; ``carry(fn)`` hands that
  decision, and the open span, to work run on another thread;
  ``recorded()`` reads them, ``clear()`` forgets them.  Under
  ``profile()`` they are written beside the Chrome trace, on its clock.
"""

import contextlib
import itertools
import json
import logging
import os
import pathlib
import socket
import threading
import time
import typing

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


_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _ThreadState(threading.local):
    # class-level defaults: a thread that never set them reads these
    # without the cost of a failed attribute lookup
    carried = False     # running work handed over by a recording thread
    stack = None        # ids of the spans open on this thread


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "start")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rec._stack().pop()
        self.rec._add(self.rec._spans, (self.name, self.start, end,
                                        threading.get_ident(), self.id,
                                        self.parent))
        return False


class Recorder:
    """Spans and counts of the program's work, kept in memory.

    A thread records while a torch profiler runs on it (the profiler's
    state is the thread's own: the benchmark's traced window, or
    ``profile()``), or while it runs work that such a thread handed it
    through ``carry``.  Otherwise a span is one check and a shared null
    context, and a count one check.

    A span is (name, start, end, thread, id, parent): start and end in
    ``time.time_ns()``'s clock, which is the clock of the profiler's host
    events and, through them, of its device events; the parent is the span
    open on the same thread when it began, or on the handing thread when
    the work was handed over.  A count is (name, time, n).  At most
    ``LIMIT`` spans and counts are kept; what comes after is counted in
    ``dropped`` and lost."""

    LIMIT = 1 << 18

    def __init__(self):
        self._lock = threading.Lock()
        self._local = _ThreadState()
        self._ids = itertools.count(1)
        self._spans, self._counts = [], []
        self.dropped = 0

    def on(self) -> bool:
        """Whether this thread records."""
        return _profiler_enabled() or self._local.carried

    def _stack(self) -> list:
        stack = self._local.stack
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, store: list, item: tuple) -> None:
        with self._lock:
            if len(self._spans) + len(self._counts) < self.LIMIT:
                store.append(item)
            else:
                self.dropped += 1

    def span(self, name: str):
        """A context manager timing what runs inside it as span ``name``."""
        if _profiler_enabled() or self._local.carried:
            return _Span(self, name)
        return _NULL

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``."""
        if _profiler_enabled() or self._local.carried:
            self._add(self._counts, (name, time.time_ns(), n))

    def carry(self, fn: typing.Callable) -> typing.Callable:
        """``fn`` to be run on another thread as this thread's work: when
        this thread records, the call records too, its spans children of
        the span open here now; otherwise ``fn`` itself."""
        if not self.on():
            return fn
        stack = self._stack()
        parent = [stack[-1]] if stack else []
        local = self._local

        def carried(*args, **kwargs):
            old = local.carried, local.stack
            local.carried, local.stack = True, list(parent)
            try:
                return fn(*args, **kwargs)
            finally:
                local.carried, local.stack = old

        return carried

    def recorded(self) -> dict:
        """``spans`` and ``counts`` (each a list of dicts, in the order they
        ended), ``counters`` (each name's total) and ``dropped``."""
        with self._lock:
            spans, counts = list(self._spans), list(self._counts)
            dropped = self.dropped
        totals = {}
        for name, _, n in counts:
            totals[name] = totals.get(name, 0) + n
        return {
            "clock": "time.time_ns",
            "spans": [dict(zip(("name", "start_ns", "end_ns", "thread", "id",
                                "parent"), s)) for s in spans],
            "counts": [dict(zip(("name", "t_ns", "n"), c)) for c in counts],
            "counters": totals, "dropped": dropped}

    def clear(self) -> None:
        with self._lock:
            self._spans, self._counts = [], []
            self.dropped = 0


RECORDER = Recorder()
span, count, carry = RECORDER.span, RECORDER.count, RECORDER.carry
recorded, clear = RECORDER.recorded, RECORDER.clear


@contextlib.contextmanager
def profile(log_dir: str = None):
    """Trace host and device execution to ``log_dir`` (default
    ``$WSUNET_PROFILE``; nothing is traced when neither is set), and write
    what the recorder kept meanwhile beside the trace, as
    ``<host>_<pid>.<ns>.spans.json`` (``recorded()``'s dict)."""
    log_dir = log_dir or os.environ.get("WSUNET_PROFILE")
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=tensorboard_trace_handler(str(log_dir))):
            yield
    finally:
        out = pathlib.Path(log_dir) / (f"{socket.gethostname()}_"
                                       f"{os.getpid()}.{time.time_ns()}"
                                       f".spans.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(recorded()))
        clear()


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
