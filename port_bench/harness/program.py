"""The program's own spans and counters in a traced run's window.

The port records spans and counters on its hot path while a torch
profiler runs on the thread that drives it (``wsunet_tpu_torch.utils.
profiling``: ``recorded()``), stamped with ``time.time_ns()``, the clock of
the profiler's events.  ``of(run)`` keeps what falls inside the window:

- the window's bounds: the harness's ``window`` span among the trace's
  host events;
- the device's idle gaps: the window less the union of the trace's
  device intervals, by ``trace.Trace._reduce``'s rule (every event on the
  card but the harness's own span names);
- the spans that lie inside the window, and the counts made in it;
- each idle gap put down to the spans open on the driving thread at the
  gap's midpoint (the harness's own midpoint rule).  The driving thread
  is the one reading: ``run.py`` reads the metrics on the thread that ran
  the window.

``of`` gives None in an untraced run, where the program has no recorder
(a commit before it), and where the recorder dropped anything (its
buffer was full), so that every reader built on it reads nothing there.
"""

import bisect
import threading

import torch

from port_bench.harness.trace import SPAN_NAMES, _ns, _union

_cache = {}


class Window:
    def __init__(self, w0, w1, spans, counts, gaps, n_device, driving):
        self.w0, self.w1 = w0, w1
        self.window_s = (w1 - w0) / 1e9
        self.spans = [s for s in spans if s["start_ns"] >= w0
                      and s["end_ns"] <= w1]
        self.counters = {}
        for c in counts:
            if w0 <= c["t_ns"] < w1:
                self.counters[c["name"]] = (self.counters.get(c["name"], 0)
                                            + c["n"])
        self.gaps = gaps
        self.n_device = n_device
        # the driving thread's spans that meet the window, by name: spans
        # of one name on one thread never overlap, so each name's are
        # searched by bisection
        self._open = {}
        for s in sorted((s for s in spans if s["thread"] == driving
                         and s["end_ns"] > w0 and s["start_ns"] < w1),
                        key=lambda s: s["start_ns"]):
            starts, ends = self._open.setdefault(s["name"], ([], []))
            starts.append(s["start_ns"])
            ends.append(s["end_ns"])

    def mean_ms(self, name: str):
        """Mean milliseconds of the spans ``name`` inside the window, or
        None where there are none."""
        d = [s["end_ns"] - s["start_ns"] for s in self.spans
             if s["name"] == name]
        return sum(d) / len(d) / 1e6 if d else None

    def open_at(self, t: int) -> list:
        """(length, name) of each span open on the driving thread at
        ``t``, innermost (shortest) first."""
        out = []
        for name, (starts, ends) in self._open.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ends[i]:
                out.append((ends[i] - starts[i], name))
        return sorted(out)

    def idle_pct_under(self, names) -> float:
        """The share (%) of the window idle while one of the spans
        ``names`` was open on the driving thread (at a gap's midpoint), or
        None where nothing ran on the card."""
        if not self.n_device:
            return None
        names = set(names)
        idle = sum(b - a for a, b in self.gaps
                   if names & {n for _, n in self.open_at((a + b) // 2)})
        return 100.0 * idle / 1e9 / self.window_s


def _recorded():
    try:
        from wsunet_tpu_torch.utils import profiling
        return profiling.recorded()
    except (ImportError, AttributeError):
        return None


def of(run):
    """The program's spans, counts and the device's idle gaps in the
    traced window (``Window``), or None."""
    if run.trace is None:
        return None
    key = id(run.trace)
    if key not in _cache:
        _cache.clear()
        _cache[key] = (run.trace, _window(run.trace))
    return _cache[key][1]


def _window(tr):
    got = _recorded()
    if got is None or got["dropped"]:
        return None
    windows, device = [], []
    for ev in tr.prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in SPAN_NAMES:
                device.append((start, end))
        elif name == "window":
            windows.append((start, end))
    if len(windows) != 1:
        return None
    w0, w1 = windows[0]
    inside = [(max(s, w0), min(e, w1)) for s, e in device
              if e > w0 and s < w1]
    gaps, cursor = [], w0
    for s, e in _union(inside):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    return Window(w0, w1, got["spans"], got["counts"], gaps, len(inside),
                  threading.get_ident())


def mean_ms(run, name: str):
    """Mean milliseconds of the program's spans ``name`` in the window."""
    w = of(run)
    return None if w is None else w.mean_ms(name)


def idle_pct_under(run, names):
    """The window's device-idle share (%) under the program's spans
    ``names`` on the driving thread."""
    w = of(run)
    return None if w is None else w.idle_pct_under(names)


def hit_pct(run, counter: str):
    """``<counter>.hit`` over ``.hit`` and ``.miss`` counted in the window,
    in %, or None where neither was counted."""
    w = of(run)
    if w is None:
        return None
    hits = w.counters.get(f"{counter}.hit", 0)
    total = hits + w.counters.get(f"{counter}.miss", 0)
    return 100.0 * hits / total if total else None
