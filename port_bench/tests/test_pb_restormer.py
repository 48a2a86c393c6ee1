"""The cell ``restormer-sweep-png`` on the CPU at small sizes: its FLOP
count against torch's counter at the published widths, whole runs with
the configuration swapped for small widths (the result line, traced and
untraced, correct), the weights it draws without the program, its
controls and planted faults in the program's path reading not correct,
the launch-linked device shares and the host's launch time on a made-up
trace, and a reference that imports nothing of the program."""

import json
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from port_bench import control
from port_bench import run as bench_run
from port_bench.drivers import predictor_png_sweep
from port_bench.harness import cells, launches, program
from port_bench.harness.restormer_flops import restormer_flops
from port_bench.reference import restormer as ref_restormer

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = cells.benchmark(ROOT)
CELL = "restormer-sweep-png"
CONFIG = cells.load_json(ROOT / "port_bench" / "configs"
                         / "restormer_gray.json")
SMALL = dict(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1,
             heads=[1, 2, 4, 8], ffn_expansion_factor=2.66)
TRAFFIC = dict(side=32, distinct_covers=3, frame_images=8, batch_size=4,
               threads=2, warmup_images=4)
SEED = 2 ** 31 + 12345


def test_count_matches_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from wsunet_tpu_torch.models import get_model

    with torch.device("meta"):
        model = get_model("restormer_gray")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 1, 32, 32, device="meta"))
    assert restormer_flops(32, CONFIG) == counter.get_total_flops()
    assert restormer_flops(512, CONFIG) == 1_237_697_298_432


@pytest.mark.parametrize("widths", ["small", "published"])
def test_drawn_weights_fit_the_programs_network(widths):
    """The published names and shapes, which the program's network loads
    strictly; conv weights within +-1/sqrt(fan_in), norm weights and
    temperatures in [0.5, 2] and not 1; the same seed, the same draw."""
    from wsunet_tpu_torch.models import get_model, restormer

    config = {**CONFIG, **SMALL} if widths == "small" else CONFIG
    shapes = ref_restormer.shapes(config)
    with torch.device("meta"):
        model = (restormer.Restormer(**SMALL) if widths == "small"
                 else get_model("restormer_gray"))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert list(shapes) == list(want) and shapes == want
    if widths == "published":
        assert sum(torch.Size(v).numel() for v in shapes.values()) == \
            CONFIG["parameters"]
        return
    sd = predictor_png_sweep.draw_state(config, SEED)
    again = predictor_png_sweep.draw_state(config, SEED)
    other = predictor_png_sweep.draw_state(config, SEED + 1)
    restormer.Restormer(**SMALL).load_state_dict(sd)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, again[k])
        assert not torch.equal(v, other[k])
        if v.dim() == 4:
            assert v.abs().max() <= v[0].numel() ** -0.5
        else:
            assert 0.5 <= v.min() and v.max() <= 2.0
            assert not torch.equal(v, torch.ones_like(v)), k


@pytest.fixture
def small(monkeypatch):
    """The cell with the configuration at small widths: the program's
    ``restormer_gray`` and the configuration the harness reads."""
    from wsunet_tpu_torch.models import restormer

    monkeypatch.setitem(restormer.NETWORKS, "restormer_gray", SMALL)
    n = sum(p.numel() for p in restormer.Restormer(**SMALL).parameters())
    context = cells.context

    def small_context(*args, **kwargs):
        ctx = context(*args, **kwargs)
        ctx.config = {**ctx.config, **SMALL, "parameters": n}
        return ctx

    monkeypatch.setattr(cells, "context", small_context)


def _run(trace=0, seconds=0.3):
    args = types.SimpleNamespace(workload=CELL, seed=SEED, seconds=seconds,
                                 trace=trace)
    return bench_run.run(BENCH, args, torch.device("cpu"), TRAFFIC)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(small, trace):
    out = _run(trace)
    json.dumps(out)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["checks"]) == {"beta_gap", "l1_gap"}
    e2e, layer = cells.metrics_of(BENCH, CELL)
    if trace:
        # on the CPU no device: the device shares read nothing; the
        # forward's span is the program's, timed on the host
        assert "launch_ms.restormer" in out["metrics"]
        assert set(out["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(out["metrics"]) == {"images_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())


def test_controls_run_in_the_programs_place(small):
    """Both controls make whole runs; the tanh GELU fails the check on
    the CPU too (TF32 needs the card: on the CPU it is float32)."""
    got = control.readings(CELL, SEED, torch.device("cpu"), TRAFFIC,
                           seconds=0.2)
    assert set(got) == {"control", "gelu_tanh"}
    assert all(set(r) == {"correct", "beta_gap", "l1_gap"}
               for r in got.values())
    assert got["gelu_tanh"]["correct"] is False, got


def _attention_zeroed(monkeypatch):
    from wsunet_tpu_torch.models import restormer

    monkeypatch.setattr(restormer.Attention, "forward",
                        lambda self, x: torch.zeros_like(x))


def _gelu_swapped(monkeypatch):
    from wsunet_tpu_torch.models import restormer

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(torch.nn.functional.gelu(
            x1, approximate="tanh") * x2)

    monkeypatch.setattr(restormer.FeedForward, "forward", forward)


@pytest.mark.parametrize("fault", [_attention_zeroed, _gelu_swapped])
def test_faults_in_the_programs_path_fail_the_check(small, fault,
                                                    monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert out["correct"] is False, out["checks"]


class _Event:
    def __init__(self, name, start, duration, cuda, link=0, own=0, tid=1):
        self._v = (name, start, duration, cuda, link, own, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def linked_correlation_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _made_up_run(events, busy_s=500e-9):
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        busy_s=busy_s, prof=types.SimpleNamespace(
            profiler=types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(
                    events=lambda: events)))))


def test_device_time_goes_to_the_span_open_at_its_launch(monkeypatch):
    """Kernels by the span open on the driving thread when their host
    operator (or, with none linked, their runtime call) started, however
    late they ran; clipped to the window; over the busy seconds."""
    import threading

    me = threading.get_ident()
    spans = [{"name": "restormer.attention", "start_ns": 100,
              "end_ns": 200, "thread": me},
             {"name": "restormer.ffn", "start_ns": 200, "end_ns": 300,
              "thread": me}]
    window = program.Window(0, 1000, spans, [], [], 4, me)
    events = [
        _Event("aten::conv2d", 110, 5, False, own=1),
        _Event("cudaLaunchKernel", 150, 2, False, link=7, own=42),
        _Event("aten::gelu", 250, 5, False, own=2),
        _Event("aten::add", 400, 5, False, own=3),
        _Event("conv", 120, 300, True, link=1),         # attention
        _Event("gemm", 500, 100, True, own=42),         # attention, late
        _Event("gelu", 990, 20, True, link=2),          # ffn, 10 inside
        _Event("add", 700, 100, True, link=3),          # no span
    ]
    run = _made_up_run(events)
    monkeypatch.setattr(program, "of", lambda r: window)
    assert launches.share_under(run, "restormer.attention") == \
        pytest.approx(100.0 * 400 / 500)
    assert launches.share_under(run, "restormer.ffn") == \
        pytest.approx(100.0 * 10 / 500)
    monkeypatch.setattr(program, "of", lambda r: None)
    assert launches.share_under(run, "restormer.ffn") is None


def test_launch_time_leaves_out_the_cuda_calls(monkeypatch):
    """Each ``restormer.forward`` span less the union of the launching
    thread's CUDA calls inside it (a call overlapping the end clipped);
    another thread's calls, operators and device events count for
    nothing; the mean over the spans, in ms."""
    import threading

    me = threading.get_ident()
    spans = [{"name": "restormer.forward", "start_ns": 0,
              "end_ns": 1_000_000, "thread": me},
             {"name": "restormer.forward", "start_ns": 2_000_000,
              "end_ns": 3_000_000, "thread": me}]
    window = program.Window(0, 4_000_000, spans, [], [], 4, me)
    events = [
        _Event("aten::conv2d", 10_000, 500_000, False, tid=1),
        _Event("cudaLaunchKernel", 100_000, 300_000, False, link=1, tid=1),
        _Event("cuLaunchKernel", 200_000, 300_000, False, link=1, tid=1),
        _Event("cudaLaunchKernel", 900_000, 400_000, False, link=2, tid=1),
        _Event("cudaMemcpyAsync", 150_000, 500_000, False, tid=2),
        _Event("cudaLaunchKernel", 2_100_000, 100_000, False, tid=1),
        _Event("cudaLaunchKernel", 1_500_000, 100_000, False, tid=1),
        _Event("conv", 100_000, 800_000, True, link=1),
    ]
    run = _made_up_run(events)
    monkeypatch.setattr(program, "of", lambda r: window)
    # span 1: 1 ms less [0.1, 0.5] and [0.9, 1.0] ms; span 2: less 0.1
    assert launches.host_ms_outside_runtime(run, "restormer.forward") == \
        pytest.approx((0.5 + 0.9) / 2)
    assert launches.host_ms_outside_runtime(run, "restormer.ffn") is None
    monkeypatch.setattr(program, "of", lambda r: None)
    assert launches.host_ms_outside_runtime(run, "restormer.forward") \
        is None


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import port_bench.reference.restormer; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('wsunet_tpu_torch', 'wsunet_tpu', 'jax', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
