"""Spans and the device trace of a run.

``Spans`` wraps the calls a driver makes into the program in named spans:
``torch.profiler.record_function`` ranges when the run is traced (so they
share the device trace's clock), nothing otherwise.  Spans are opened on
the thread that drives the program only.

``Trace`` runs ``torch.profiler`` (CPU and CUDA activities) over the
measured window and reduces it, once the window has closed:

- device intervals: every event on the card (kernels, copies, sets), the
  benchmark's own span names left out (the profiler mirrors annotation
  ranges onto the device's timeline);
- ``busy_s``: the length of the union of device intervals inside the
  window; ``window_s``: the length of the window's span;
- ``kernels``: (name, seconds) of every device event, for the per-layer
  readers;
- ``idle``: each gap between device intervals inside the window, named by
  what the driving thread was in at the gap's midpoint: the innermost span,
  with a sweep's time outside its ``predict`` spans split into
  ``pass_fill`` (before its first batch is launched), ``decode`` (waiting
  for the next batch) and ``pass_drain`` (after its last), and
  ``host_other`` outside every span.
"""

import bisect
import contextlib

import torch

SPAN_NAMES = ("window", "sweep", "predict", "step", "decode", "draw",
              "loss_read")


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def _ns(event, what):
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Labels:
    """What the driving thread was in at a time: spans of one name never
    overlap, so each name's spans are searched by bisection, and the
    shortest span around the time is the innermost."""

    def __init__(self, spans):
        self.by_name = {}
        for s, e, n in sorted(spans):
            starts, ends = self.by_name.setdefault(n, ([], []))
            starts.append(s)
            ends.append(e)
        self.predicts = self.by_name.get("predict", ([], []))

    def _around(self, name, t):
        starts, ends = self.by_name[name]
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ends[i]:
            return starts[i], ends[i]
        return None

    def __call__(self, t) -> str:
        best = None
        for name in self.by_name:
            span = self._around(name, t)
            if span and (best is None or span[1] - span[0] < best[1]):
                best = (name, span[1] - span[0], span)
        if best is None:
            return "host_other"
        if best[0] != "sweep":
            return best[0]
        s0, s1 = best[2]
        starts, ends = self.predicts
        lo = bisect.bisect_left(starts, s0)
        hi = bisect.bisect_left(starts, s1)
        if lo == hi or t < starts[lo]:
            return "pass_fill"
        if t >= ends[hi - 1]:
            return "pass_drain"
        return "decode"


class Trace:
    def __init__(self):
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self):
        events = self.prof.profiler.kineto_results.events()
        device, spans = [], []
        for ev in events:
            name = ev.name()
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if name not in SPAN_NAMES:
                    device.append((start, end, name))
            elif name in SPAN_NAMES:
                spans.append((start, end, name))
        windows = [s for s in spans if s[2] == "window"]
        if len(windows) != 1:
            raise RuntimeError(f"expected one window span in the trace, "
                               f"found {len(windows)}")
        w0, w1 = windows[0][:2]
        inside = [(max(s, w0), min(e, w1), n) for s, e, n in device
                  if e > w0 and s < w1]
        busy = _union([(s, e) for s, e, _ in inside])
        self.window_s = (w1 - w0) / 1e9
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.kernels = [(n, (e - s) / 1e9) for s, e, n in inside]
        self.n_device_events = len(inside)
        gaps, cursor = [], w0
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if w1 > cursor:
            gaps.append((cursor, w1))
        what = _Labels([s for s in spans if s[2] != "window"])
        self.idle = [(what((a + b) // 2), (b - a) / 1e9) for a, b in gaps]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing: its totals, then the longest gaps."""
        by_name = {}
        for name, sec in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + sec
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        totals = {}
        for what, sec in self.idle:
            totals[what] = totals.get(what, 0.0) + sec
        gaps = [[f"total:{w}", s] for w, s in
                sorted(totals.items(), key=lambda kv: -kv[1])]
        longest = sorted(self.idle, key=lambda g: -g[1])
        gaps += [[f"longest:{w}", s] for w, s in longest]
        return {"device_ops": [[n[:64], s] for n, s in ops],
                "idle_gaps": gaps[:top]}
