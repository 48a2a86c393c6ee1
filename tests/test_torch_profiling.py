"""The port's spans and counters (``utils.profiling``'s recorder) on the
CPU: nothing is recorded without a torch profiler on the driving thread;
under one, a sweep and a training step record their spans, those of the
prefetch and decode threads too, each under the span that caused it; the
spans share the profiler's clock; the counters count the caches' hits,
misses and overflows, exactly under many threads; the buffer is bounded;
``WSUNET_PROFILE`` writes the spans file beside the Chrome trace."""

import concurrent.futures
import json
import os
import shutil
import socket
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, record_function

from torch_p128 import P128
from wsunet_tpu_torch.data import pipeline
from wsunet_tpu_torch.utils import profiling

N, B = 10, 4          # ten images, batches of four: three batches


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("covers")
    for p in sorted((P128 / "images").glob("*.png"))[:N]:
        shutil.copyfile(p, root / p.name)
    return root


@pytest.fixture
def names(root):
    pipeline.clear_decode_cache()
    profiling.clear()
    yield sorted(p.name for p in root.glob("*.png"))
    pipeline.clear_decode_cache()
    profiling.clear()


def _profiler():
    return torch.profiler.profile(activities=[ProfilerActivity.CPU])


def _sweep(root, names):
    return pipeline.sweep_batches(
        root, names, lambda px: (torch.as_tensor(px).float().mean((1, 2)),),
        B, threads=2, device_cache=True, device="cpu")


def _train(root, names):
    from wsunet_tpu_torch.models import get_model
    from wsunet_tpu_torch.parallel import get_mesh
    from wsunet_tpu_torch.train import common, losses, train_unet

    torch.manual_seed(0)
    model = get_model("unet_2", drop_rate=None)
    opt, sched = train_unet.make_optimizer(
        {"learning_rate": 1e-3, "lr_schedule": None, "num_epochs": 1}, 1,
        model.parameters())
    step = train_unet._make_step(model, losses.get_loss("l1", per_image=True),
                                 opt, sched, "LSBR", 0.4, crop=32)[0]
    gen = torch.Generator().manual_seed(0)
    for _, pixels, mask in common.rank_batches(
            get_mesh(), root, names, 2, pipeline.imread_gray_u8,
            torch.device("cpu")):
        step(pixels, mask, gen)


WORK = {"sweep": _sweep, "train": _train}
# each span's parent, by name (None: opened with none open), and whether
# it runs on the driving thread
SPANS = {
    "sweep": {"sweep": (None, True), "pipeline.wait": ("sweep", True),
              "sweep.collect": ("sweep", True),
              "pipeline.batch": ("sweep", False),
              "pipeline.read": ("pipeline.batch", False)},
    "train": {"train.fetch": (None, True),
              "pipeline.wait": ("train.fetch", True),
              "train.mask": ("train.fetch", True),
              "pipeline.batch": ("train.fetch", False),
              "pipeline.read": ("pipeline.batch", False),
              "train.step": (None, True),
              "train.forward": ("train.step", True),
              "train.backward": ("train.step", True),
              "train.optimizer": ("train.step", True)},
}


@pytest.mark.parametrize("work", sorted(WORK))
@pytest.mark.parametrize("traced", [False, True])
def test_spans_follow_the_profiler_of_the_driving_thread(root, names, work,
                                                          traced):
    if traced:
        with _profiler():
            WORK[work](root, names)
    else:
        WORK[work](root, names)
    got = profiling.recorded()
    if not traced:
        assert got["spans"] == [] and got["counts"] == []
        return
    assert got["dropped"] == 0
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    assert {s["name"] for s in spans} == set(SPANS[work])
    me = threading.get_ident()
    for s in spans:
        parent, driving = SPANS[work][s["name"]]
        assert (s["thread"] == me) is driving, s
        assert (by_id[s["parent"]]["name"] if s["parent"] else None) \
            == parent, s
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"]:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"]
    assert sum(s["name"] == "pipeline.read" for s in spans) == N


def test_program_spans_share_the_profilers_clock(names):
    """A program span around a ``record_function`` range holds the range
    in the profiler's events, and is not one of them."""
    with _profiler() as prof:
        with profiling.span("outer"):
            with record_function("inner"):
                torch.ones(1000).sum()
    outer, = profiling.recorded()["spans"]
    events = prof.profiler.kineto_results.events()
    inner, = [e for e in events if e.name() == "inner"]
    assert outer["start_ns"] <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer["end_ns"]
    assert not any(e.name() == "outer" for e in events)


@pytest.mark.parametrize("budget", [pipeline._DEVICE_CACHE_BUDGET, 0])
def test_cache_counters_of_two_passes(root, names, budget, monkeypatch):
    """A second pass over the same rows: one device-cache hit a batch and
    no miss, or with no room in the device cache every batch over budget
    and looked up again; the images decoded once either way."""
    monkeypatch.setattr(pipeline, "_DEVICE_CACHE_BUDGET", budget)
    passes = []
    for _ in range(2):
        with _profiler():
            _sweep(root, names)
        passes.append(profiling.recorded()["counters"])
        profiling.clear()
    n_batches = -(-N // B)
    first, second = passes
    assert first == {"pipeline.device_cache.miss": n_batches,
                     "pipeline.decode_cache.hit": 0,
                     "pipeline.decode_cache.miss": N,
                     **({"pipeline.device_cache.over_budget": n_batches}
                        if budget == 0 else {})}
    if budget:
        assert second == {"pipeline.device_cache.hit": n_batches}
    else:
        assert second == {"pipeline.device_cache.miss": n_batches,
                          "pipeline.decode_cache.hit": N,
                          "pipeline.decode_cache.miss": 0,
                          "pipeline.device_cache.over_budget": n_batches}


def test_failed_decodes_are_counted(root, names, tmp_path):
    for n in names[:3]:
        shutil.copyfile(root / n, tmp_path / n)
    (tmp_path / names[1]).write_bytes(b"not a png")
    with _profiler():
        out = _sweep(tmp_path, names[:3])
    assert np.isnan(out[1]).all() and not np.isnan(out[[0, 2]]).any()
    assert profiling.recorded()["counters"]["pipeline.decode_failed"] == 1


def test_counts_from_many_threads_are_exact(names):
    """Threads handed work by the driving thread count at once; no count
    is lost, and every span gets its own id."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(_):
        for _ in range(500):
            profiling.count("c")
            with profiling.span("s"):
                pass

    try:
        with _profiler(), \
                concurrent.futures.ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(profiling.carry(work), i)
                       for i in range(32)]
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    got = profiling.recorded()
    assert got["counters"] == {"c": 32 * 500}
    assert len({s["id"] for s in got["spans"]}) == 32 * 500


def test_worker_threads_record_only_what_they_are_handed(names):
    seen = []

    def work():
        seen.append(profiling.RECORDER.on())
        with profiling.span("lost"):
            profiling.count("lost")

    with _profiler():
        assert profiling.RECORDER.on()
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pool.submit(work).result(timeout=60)
    assert seen == [False, False]
    assert profiling.recorded()["spans"] == []
    assert not profiling.RECORDER.on()


def test_buffer_is_bounded_and_counts_what_it_drops():
    rec = profiling.Recorder()
    rec.LIMIT = 5
    with _profiler():
        for _ in range(4):
            with rec.span("s"):
                rec.count("c")
    got = rec.recorded()
    assert len(got["spans"]) + len(got["counts"]) == 5
    assert got["dropped"] == 3
    rec.clear()
    assert rec.recorded() == {"clock": "time.time_ns", "spans": [],
                              "counts": [], "counters": {}, "dropped": 0}


def test_wsunet_profile_writes_the_spans_beside_the_trace(root, names,
                                                          tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("WSUNET_PROFILE", str(tmp_path / "trace"))
    with profiling.profile():
        _sweep(root, names)
    stem = f"{socket.gethostname()}_{os.getpid()}."
    trace, = (tmp_path / "trace").glob(f"{stem}*.pt.trace.json")
    spans_file, = (tmp_path / "trace").glob(f"{stem}*.spans.json")
    got = json.loads(spans_file.read_text())
    assert got["clock"] == "time.time_ns" and got["dropped"] == 0
    assert {s["name"] for s in got["spans"]} == set(SPANS["sweep"])
    assert got["counters"]["pipeline.device_cache.miss"] == -(-N // B)
    assert profiling.recorded()["spans"] == []
