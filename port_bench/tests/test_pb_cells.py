"""The benchmark's description and its parts, found by name (CPU)."""

import json
import pathlib
import re

import pytest

from port_bench.harness import cells, flops

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = cells.workload(BENCH, cell)
    assert w["chips"] == 1
    ctx = cells.context(ROOT, BENCH, cell, 1, "cpu", ROOT, None)
    assert ctx.config["name"] == w["config"]
    cells.driver(ctx.traffic["kind"]).Cell
    e2e, layer = cells.metrics_of(BENCH, cell)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        if m["name"] != "setup_s":
            assert callable(cells.reader(m["name"]))


def test_names_units_and_metric_links():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert cells.load_json(ROOT / c["file"])["reduced"] == c["reduced"]


def _config(name):
    return cells.load_json(ROOT / "port_bench" / "configs" / f"{name}.json")


def test_counts_of_the_yardstick():
    unet, b0 = _config("unet_2"), _config("efficientnet_b0_nostride")
    assert flops.unet_flops(512, unet) == 202_199_007_232
    assert round(flops.b0_flops(512, b0) / 1e9, 1) == 16.0
    h100 = flops.PEAKS["H100 80GB HBM3"]
    assert abs(flops.unet_b1_bound_s(32, 512, unet, h100) * 1e3
               - 92.96) < 0.005
    assert flops.peaks("NVIDIA H100 80GB HBM3") is h100
    assert flops.peaks("cpu") is None


def test_b0_count_matches_the_layers_run():
    """``b0_flops`` against the multiply-accumulates the port's B0 runs,
    counted by hooks on every conv and the classifier at 64^2."""
    import torch

    from wsunet_tpu_torch.models import get_b0

    model = get_b0(in_channels=2, no_stem_stride=True,
                   quadratic_stem=True).eval()
    macs = []

    def hook(mod, _, out):
        if isinstance(mod, torch.nn.Conv2d):
            macs.append(out[0].numel() * mod.weight[0].numel())
        elif isinstance(mod, torch.nn.Linear):
            macs.append(mod.weight.numel())

    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 2, 64, 64))
    assert 2 * sum(macs) == flops.b0_flops(
        64, _config("efficientnet_b0_nostride"))


def test_loader_hands_the_ports_layout():
    """The benchmark's loader gives the tensors the port's own converter
    gives, for both committed runs."""
    import torch

    from port_bench.harness import weights
    from wsunet_tpu_torch.models import (b0_state_dict_from_flax,
                                         unet_state_dict_from_flax)
    from wsunet_tpu_torch.train.checkpoint import load_params

    for cfg, convert in (("unet_2", lambda p: unet_state_dict_from_flax(
            p[0])), ("efficientnet_b0_nostride",
                     lambda p: b0_state_dict_from_flax(*p))):
        c = cells.load_json(ROOT / "port_bench" / "configs" / f"{cfg}.json")
        mine = weights.state_dict(ROOT / c["weights"])
        theirs = convert(load_params(ROOT / c["weights"]))
        assert set(mine) == set(theirs)
        assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
        assert weights.n_parameters(mine) == c["parameters"]
