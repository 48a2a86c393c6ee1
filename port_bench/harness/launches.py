"""Device time by the program's span open at each operation's launch, in
a traced run's window.

Each device event of the trace (every event on the card but the
harness's own span names, ``trace.Trace``'s rule) is linked to the host
operation that launched it by the profiler's correlation ids: a device
event's ``linked_correlation_id()`` is the ``correlation_id()`` of the
host operator event whose call launched it (the runtime call's own id,
the device event's ``correlation_id()``, where no operator is linked).
The launch's start is then looked up among the spans open on the driving
thread (``program.Window.open_at``), so the device time of a kernel is
put down to the program's span that launched it, however late the card
ran it.

``host_ms_outside_runtime(run, name)``: the mean host milliseconds of
the program's spans ``name`` less the time the launching thread spent
inside the CUDA runtime's and driver's calls during each (host events
named ``cu...``: kernel launches, copies, event and stream calls).  A
launch blocks while the card's launch queue is full, so under
back-pressure the span's length follows the card's pace; what is left is
the host's own cost of issuing the work (Python, ATen's dispatch, the
libraries' planning).  The launching thread is the one that made most of
those calls inside the spans; on a host without CUDA calls the spans are
read whole.

``share_under(run, name)``: the share (%) of the window's busy device
time (``trace.busy_s``) in device events, clipped to the window, launched
while a span ``name`` was open; None in an untraced run, where the
program recorded nothing (``program.of``) or nothing ran on the card.
"""

import bisect
import collections

import torch

from port_bench.harness import program
from port_bench.harness.trace import SPAN_NAMES, _ns, _union

_cache = {}


def _seconds_by_span(run) -> dict:
    """{span name: device seconds launched under it} in the window."""
    w = program.of(run)
    ops, runtime, device = {}, {}, []
    for ev in run.trace.prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.name() not in SPAN_NAMES:
                device.append((start, start + _ns(ev, "duration"),
                               ev.linked_correlation_id(),
                               ev.correlation_id()))
        elif ev.linked_correlation_id() == 0:
            ops[ev.correlation_id()] = start
        else:
            runtime[ev.correlation_id()] = start
    seconds = {}
    for s, e, link, own in device:
        s, e = max(s, w.w0), min(e, w.w1)
        t = ops.get(link, runtime.get(own))
        if e <= s or t is None:
            continue
        for name in {n for _, n in w.open_at(t)}:
            seconds[name] = seconds.get(name, 0.0) + (e - s) / 1e9
    return seconds


def share_under(run, name: str):
    """The share (%) of the window's busy device time launched under the
    program's span ``name`` (module docstring), or None."""
    w = program.of(run)
    if w is None or not w.n_device or run.trace.busy_s <= 0:
        return None
    key = id(run.trace)
    if key not in _cache:
        _cache.clear()
        _cache[key] = (run.trace, _seconds_by_span(run))
    return 100.0 * _cache[key][1].get(name, 0.0) / run.trace.busy_s


def host_ms_outside_runtime(run, name: str):
    """Mean host ms of the program's spans ``name`` in the window, less
    the launching thread's time inside CUDA calls (module docstring), or
    None."""
    w = program.of(run)
    if w is None:
        return None
    spans = sorted((s["start_ns"], s["end_ns"]) for s in w.spans
                   if s["name"] == name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    calls, threads = collections.defaultdict(list), collections.Counter()
    for ev in run.trace.prof.profiler.kineto_results.events():
        if (ev.device_type() == torch.autograd.DeviceType.CUDA
                or not ev.name().startswith("cu")):
            continue
        t = _ns(ev, "start")
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= spans[i][1]:
            continue
        tid = ev.start_thread_id()
        threads[tid] += 1
        calls[i].append((tid, t, min(t + _ns(ev, "duration"), spans[i][1])))
    inside = 0
    if threads:
        tid = threads.most_common(1)[0][0]
        for got in calls.values():
            inside += sum(e - s for s, e in _union(
                (s, e) for th, s, e in got if th == tid))
    return (sum(e - s for s, e in spans) - inside) / len(spans) / 1e6
