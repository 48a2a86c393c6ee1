"""On the card (marker ``cuda``; each test skips without one): a whole
run of every cell at its own size with each of its controls in the
program's place (the plain reference in TF32; for training also the
planted faults) comes out not correct, and a run of each cell at a
reduced size is correct.

    python -m pytest --noconftest -m cuda port_bench/tests -q

``port_bench/control.py`` reads the controls on more seeds (PERF.md gives
the readings)."""

import pathlib
import types

import pytest
import torch

from port_bench import control
from port_bench import run as bench_run
from port_bench.harness import cells

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = cells.benchmark(ROOT)
SWEEP = dict(side=256, distinct_covers=4, frame_images=64, batch_size=32,
             warmup_images=32)
REDUCED = {
    "unet2-sweep-png-b1": SWEEP,
    "unet2-sweep-png-cudnn": SWEEP,
    "b0ns-sweep-resident": dict(side=256, distinct_covers=4, covers=64),
    "unet2-train-lsbr": dict(side=256, crop=256, covers=16, max_steps=200),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(REDUCED))
def test_control_fails_the_check(cell):
    dev = _card()
    got = control.readings(cell, 2 ** 31 + 99, dev)
    assert "control" in got
    assert not any(v["correct"] for v in got.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(REDUCED))
def test_reduced_run_is_correct(cell):
    dev = _card()
    args = types.SimpleNamespace(workload=cell, seed=2 ** 31 + 98,
                                 seconds=2.0, trace=0)
    out = bench_run.run(BENCH, args, dev, overrides=REDUCED[cell])
    assert out["correct"] is True, out["checks"]
