"""The readers of the program's own spans and counters
(``harness.program``) on the CPU: a traced run of each cell reads its
host-side metrics as positive numbers and its idle shares as nothing (no
card, no device events); a program without the recorder reads nothing and
the run goes on; idle gaps go to the spans open on the driving thread."""

import threading
import types

import pytest

from port_bench.harness import program
from test_pb_run import SMALL, _run

HOST = {"unet2-sweep-png-b1": ["read_ms.sweep", "batch_wait_ms.sweep"],
        "unet2-sweep-png-cudnn": ["read_ms.sweep", "batch_wait_ms.sweep"],
        "b0ns-sweep-resident": ["device_cache_hit_pct.detector"],
        "unet2-train-lsbr": ["fetch_ms.train", "launch_ms.train"]}
IDLE = ["idle_wait_pct.sweep", "idle_fetch_pct.train"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reads_the_programs_metrics(cell):
    out = _run(cell, trace=1)
    assert out["correct"] is True
    got = out["metrics"]
    for m in HOST[cell]:
        assert got[m]["value"] > 0, m
    assert not set(IDLE) & set(got)
    if cell == "b0ns-sweep-resident":
        assert got["device_cache_hit_pct.detector"]["value"] == 100.0


@pytest.mark.parametrize("cell", ["unet2-sweep-png-cudnn",
                                  "unet2-train-lsbr"])
def test_a_program_without_the_recorder_reads_nothing(cell, monkeypatch):
    from wsunet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    out = _run(cell, trace=1)
    assert out["correct"] is True
    assert not set(HOST[cell]) & set(out["metrics"])


def test_idle_gaps_go_to_the_driving_threads_spans():
    me = threading.get_ident()

    def s(name, a, b, thread=me):
        return {"name": name, "start_ns": a, "end_ns": b, "thread": thread,
                "id": a, "parent": None}

    spans = [s("train.fetch", 0, 100), s("pipeline.wait", 10, 60),
             s("train.step", 200, 300), s("pipeline.read", 0, 1000, 1),
             s("train.fetch", 900, 1100)]
    counts = [{"name": "c.hit", "t_ns": 50, "n": 3},
              {"name": "c.hit", "t_ns": 1000, "n": 5}]
    gaps = [(20, 30), (70, 90), (150, 160), (210, 250), (950, 1000)]
    w = program.Window(0, 1000, spans, counts, gaps, 7, me)
    assert [w.open_at((a + b) // 2) for a, b in gaps] == [
        [(50, "pipeline.wait"), (100, "train.fetch")], [(100, "train.fetch")],
        [], [(100, "train.step")], [(200, "train.fetch")]]
    assert w.idle_pct_under({"train.fetch"}) == pytest.approx(8.0)
    assert w.counters == {"c.hit": 3}
    # spans cut by the window's end are left out of the means
    assert w.mean_ms("train.fetch") == 100 / 1e6
    run = types.SimpleNamespace(trace=None)
    assert program.of(run) is None and program.hit_pct(run, "c") is None
