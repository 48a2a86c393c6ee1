"""The readers of the gated FFN's kernel in ``restormer-sweep-png`` on
the CPU: ``b4_roofline`` takes the byte bounds of whole forwards of 44
``gdfn_gate_kernel`` launches over their device time and reads nothing
from a trace without them (a program without B4), and
``gdfn_kernel_pct.restormer`` is the hit share of the program's
``restormer.gdfn_kernel`` counters, nothing where neither was counted."""

import pathlib
import threading
import types

import pytest

from port_bench.harness import cells, program

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = cells.load_json(ROOT / "port_bench" / "configs"
                         / "restormer_gray.json")
KERNEL = "(anonymous namespace)::gdfn_gate_kernel(CUtensorMap_st, " \
    "(anonymous namespace)::Params)"


def _run(kernels, trace=True):
    tr = types.SimpleNamespace(kernels=kernels) if trace else None
    return types.SimpleNamespace(
        trace=tr, config=CONFIG, traffic={"side": 512, "batch_size": 32},
        peaks={"float32": 67e12, "bytes_per_s": 3.35e12})


def test_roofline_counts_the_blocks_bytes():
    """44 blocks a forward: (h, side) of the four levels and of decoder 1
    and the refinement at twice the first width; 12.03 GB an image."""
    reader = cells.reader("b4_roofline").__globals__
    blocks = reader["blocks"](512, CONFIG)
    assert len(blocks) == 44
    assert sorted(set(blocks)) == [(127, 512), (255, 256), (255, 512),
                                   (510, 128), (1021, 64)]
    assert blocks.count((255, 512)) == 8
    assert reader["forward_bytes"](32, 512, CONFIG) == 384_849_796_032


def test_roofline_reads_whole_forwards_only():
    read = cells.reader("b4_roofline")
    bound = read.__globals__["forward_bytes"](32, 512, CONFIG) / 3.35e12
    other = [("void at::native::conv_depthwise2d_forward_kernel", 1.0)]
    assert read(_run([(KERNEL, 0.004)] * 88 + other)) == \
        pytest.approx(100.0 * 2 * bound / (88 * 0.004))
    assert read(_run([(KERNEL, 0.004)] * 45 + other)) is None
    assert read(_run(other)) is None
    assert read(_run([(KERNEL, 0.004)] * 44, trace=False)) is None


def test_hit_share_of_the_counters(monkeypatch):
    read = cells.reader("gdfn_kernel_pct.restormer")
    me = threading.get_ident()

    def window(counts):
        return program.Window(0, 1000, [], [
            {"name": name, "t_ns": t, "n": n} for name, t, n in counts],
            [], 1, me)

    run = types.SimpleNamespace(trace=object())
    for counts, want in (
            ([("restormer.gdfn_kernel.hit", 10, 44),
              ("restormer.gdfn_kernel.hit", 500, 44)], 100.0),
            ([("restormer.gdfn_kernel.hit", 10, 33),
              ("restormer.gdfn_kernel.miss", 20, 11),
              ("restormer.gdfn_kernel.miss", 2000, 44)], 75.0),
            ([("restormer.padded", 10, 1)], None)):
        monkeypatch.setattr(program, "of", lambda r, c=counts: window(c))
        assert read(run) == want
    monkeypatch.setattr(program, "of", lambda r: None)
    assert read(run) is None
