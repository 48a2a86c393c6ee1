"""Whole runs of every cell at small sizes on the CPU (the look for a
card skipped): the result line's keys, a correct run, and the check
coming out false with the timed path broken underneath, once for each
fault the cell can have."""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

from port_bench import run as bench_run
from port_bench.harness import cells

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = cells.benchmark(ROOT)
SWEEP = dict(side=32, distinct_covers=3, frame_images=8, batch_size=4,
             threads=2, warmup_images=4)
SMALL = {
    "unet2-sweep-png-b1": SWEEP,
    "unet2-sweep-png-cudnn": SWEEP,
    "b0ns-sweep-resident": dict(side=32, distinct_covers=2, covers=8,
                                batch_size=4, threads=2),
    "unet2-train-lsbr": dict(side=32, crop=32, covers=8, max_steps=60),
}
SEED = 2 ** 31 + 12345


def _run(cell, trace=0, seconds=0.3):
    args = types.SimpleNamespace(workload=cell, seed=SEED, seconds=seconds,
                                 trace=trace)
    return bench_run.run(BENCH, args, torch.device("cpu"),
                         overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(cell, trace):
    out = _run(cell, trace)
    json.dumps(out)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    ctx = cells.context(ROOT, BENCH, cell, SEED, "cpu", ROOT, None)
    assert set(out["checks"]) == set(ctx.limits)
    e2e, layer = cells.metrics_of(BENCH, cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: the shares of peaks read nothing
        assert set(out["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in out["metrics"].values())


def _half_batch(fn):
    """``fn`` on the first half of the batch; the rest of the rows get
    the mean of those."""
    def broken(*args, **kw):
        x = args[1]
        h = x.shape[0] // 2
        outs = fn(args[0], x[:h], *args[2:], **kw)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        full = tuple(torch.cat([o, o.mean().expand(x.shape[0] - h)])
                     for o in outs)
        return full[0] if single else full
    return broken


def _altered(fn):
    """``fn`` with its first answer of every batch moved by 1e-2."""
    def broken(*args, **kw):
        outs = fn(*args, **kw)
        first = outs[0] if isinstance(outs, tuple) else outs
        first = first.clone()
        first[0] += 1e-2
        return (first,) + tuple(outs[1:]) if isinstance(outs, tuple) \
            else first
    return broken


SWEEP_TARGET = {
    "unet2-sweep-png-b1": ("wsunet_tpu_torch.ws.unet_eval",
                           "predict_batch"),
    "unet2-sweep-png-cudnn": ("wsunet_tpu_torch.ws.unet_eval",
                              "predict_batch"),
    "b0ns-sweep-resident": ("wsunet_tpu_torch.detect.b0_eval", "infer_b0"),
}


@pytest.mark.parametrize("cell", sorted(SWEEP_TARGET))
@pytest.mark.parametrize("fault", [_half_batch, _altered])
def test_sweep_faults_fail_the_check(cell, fault, monkeypatch):
    import importlib

    module, name = SWEEP_TARGET[cell]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    out = _run(cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_controls_run_in_the_programs_place(cell):
    """Every control of the cell makes a whole run with every number
    compared; the planted faults fail the check on the CPU too (the TF32
    control needs the card: on the CPU it computes float32)."""
    from port_bench import control

    got = control.readings(cell, SEED, torch.device("cpu"), SMALL[cell],
                           seconds=0.2)
    limits = cells.context(ROOT, BENCH, cell, SEED, "cpu", ROOT,
                           None).limits
    assert "control" in got
    for variant, readings in got.items():
        assert set(readings) == {"correct"} | set(limits)
        if variant != "control":
            assert readings["correct"] is False, (variant, readings)


def _state_unchanged(monkeypatch):
    from wsunet_tpu_torch.train import train_unet

    make = train_unet.make_optimizer

    def frozen(*a, **k):
        opt, sched = make(*a, **k)
        opt.step = lambda *_, **__: None
        return opt, sched

    monkeypatch.setattr(train_unet, "make_optimizer", frozen)


def _train_half_batch(monkeypatch):
    from wsunet_tpu_torch.train import train_unet

    loss = train_unet.Sampler.loss

    def half(self, cover_u8, mask, d):
        h = cover_u8.shape[0] // 2
        return loss(self, cover_u8[:h], mask[:h],
                    {k: v[:h] for k, v in d.items()})

    monkeypatch.setattr(train_unet.Sampler, "loss", half)


def _train_altered(monkeypatch):
    from wsunet_tpu_torch.train import train_unet

    loss = train_unet.Sampler.loss

    def altered(self, *a):
        out = loss(self, *a)
        return (out[0] * (1 + 1e-3),) + tuple(out[1:])

    monkeypatch.setattr(train_unet.Sampler, "loss", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _train_half_batch,
                                   _train_altered])
def test_training_faults_fail_the_check(fault, monkeypatch):
    fault(monkeypatch)
    out = _run("unet2-train-lsbr")
    assert out["correct"] is False, out["checks"]


def test_jax_side_modules_refuse_the_result(monkeypatch, capsys):
    import sys

    monkeypatch.setitem(sys.modules, "wsunet_tpu", types.ModuleType("x"))
    assert bench_run.forbidden_modules() == ["wsunet_tpu"]
    assert _run("unet2-sweep-png-cudnn") is None
    assert "wsunet_tpu" in capsys.readouterr().err


def test_port_is_not_the_jax_package(monkeypatch):
    import sys

    monkeypatch.delitem(sys.modules, "wsunet_tpu", raising=False)
    for name in ("wsunet_tpu_torch", "jaxfoo", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench_run.forbidden_modules() == []


def test_traced_idle_labels():
    from port_bench.harness.trace import _Labels

    spans = [(0, 100, "sweep"), (10, 20, "predict"), (30, 40, "predict"),
             (200, 300, "step")]
    what = _Labels(spans)
    assert [what(t) for t in (5, 15, 25, 50, 150, 250)] == [
        "pass_fill", "predict", "decode", "pass_drain", "host_other",
        "step"]


def test_inputs_follow_the_seed(tmp_path):
    from port_bench.drivers import png_sweep

    t = {**cells.load_json(ROOT / "port_bench" / "traffic"
                           / "png-sweep-b32.json"), **SWEEP}
    a = png_sweep.make_inputs(SEED, t, tmp_path / "a")
    b = png_sweep.make_inputs(SEED, t, tmp_path / "b")
    for k in a["kinds"]:
        np.testing.assert_array_equal(a["pixels"][k], b["pixels"][k])
        np.testing.assert_array_equal(a["order"][k], b["order"][k])
    assert (tmp_path / "a" / a["names"]["cover"][0]).read_bytes() == \
        (tmp_path / "b" / b["names"]["cover"][0]).read_bytes()
