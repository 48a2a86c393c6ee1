"""Restormer as the WS cover predictor (``models.restormer``), on the CPU,
against the benchmark's plain reference (``port_bench/reference/
restormer.py``) at small widths on seeded weights; the published
configuration's size; the trainer, the run it writes and the sweep that
reads it back; the options the network refuses."""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from port_bench.reference import restormer as ref  # noqa: E402
from wsunet_tpu_torch.models import get_model  # noqa: E402
from wsunet_tpu_torch.models import restormer  # noqa: E402
from wsunet_tpu_torch.utils import profiling  # noqa: E402
from wsunet_tpu_torch.utils.errors import UserError  # noqa: E402

P128 = REPO / "data_ablation" / "p128"
SMALL = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8), ffn_expansion_factor=2.66)
# The port against the reference, |output| about 1: both compute the same
# float32 operations in another form (NCHW norms against the published
# [B, HW, C] view, modules against functions), so they may differ by the
# rounding of some tens of ops a block, 1e-6 at most at these widths
# (0.0 seen); the altered references below move the output by 6e-5 (the
# tanh GELU) to 0.3 (the centred norm).
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(seed=5):
    """A small Restormer on seeded weights, its norms' weights and
    temperatures drawn in [0.5, 2] (``init_restormer`` sets them to 1,
    where a comparison could not see them), with its state dict."""
    model = restormer.init_restormer(restormer.Restormer(**SMALL), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() != 4:
                p.copy_(torch.empty(p.shape).uniform_(0.5, 2.0, generator=g))
    return model.eval(), {k: v.clone() for k, v in model.state_dict().items()}


def _x(shape, seed=3):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("shape", [(2, 1, 60, 68), (3, 1, 32, 32)])
def test_forward_matches_the_reference(shape):
    """60x68 is padded to 64x72 and cropped back; B > 1."""
    model, sd = _small()
    x = _x(shape)
    with torch.no_grad():
        got, want = model(x), ref.forward(sd, x)
    assert got.shape == x.shape
    assert (got - want).abs().max().item() <= ATOL


def _no_temperature(sd):
    return {k: torch.ones_like(v) if k.endswith("temperature") else v
            for k, v in sd.items()}


@pytest.mark.parametrize("altered", ["no_temperature", "centred_norm",
                                     "tanh_gelu"])
def test_altered_references_break_the_tolerance(altered, monkeypatch):
    model, sd = _small()
    x = _x((2, 1, 32, 40))
    approximate = "none"
    if altered == "no_temperature":
        sd = _no_temperature(sd)
    elif altered == "centred_norm":
        norm = ref.layer_norm
        monkeypatch.setattr(ref, "layer_norm", lambda h, w: norm(
            h - h.mean(1, keepdim=True), w))
    else:
        approximate = "tanh"
    with torch.no_grad():
        gap = (model(x) - ref.forward(sd, x, approximate)).abs().max()
    assert gap.item() > ATOL


def test_published_configuration():
    with torch.device("meta"):
        model = get_model("restormer_gray")
    assert sum(p.numel() for p in model.parameters()) == 26_109_076
    assert list(model.state_dict())[:3] == [
        "patch_embed.proj.weight", "encoder_level1.0.norm1.body.weight",
        "encoder_level1.0.attn.temperature"]


def test_init_is_seeded_and_the_modules_own():
    a = restormer.init_restormer(restormer.Restormer(**SMALL), 7)
    b = restormer.init_restormer(restormer.Restormer(**SMALL), 7)
    c = restormer.init_restormer(restormer.Restormer(**SMALL), 8)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q)
        if p.dim() == 4:
            bound = p[0].numel() ** -0.5
            assert not torch.equal(p, r) and p.abs().max() <= bound
            assert p.abs().max() > 0.9 * bound, name
        else:
            assert torch.equal(p, torch.ones_like(p)), name


@pytest.mark.parametrize("options", [
    dict(fast_conv=True), dict(compute_dtype=torch.bfloat16),
    dict(drop_rate=0.1), dict(disable_center=True)])
def test_refused_options_name_the_network(options):
    with pytest.raises(UserError, match="restormer_gray"):
        get_model("restormer_gray", **options)


def test_spans_and_the_pad_counter():
    """Under a profiler: one ``restormer.forward`` a call, an attention
    and an FFN span in each block, and ``restormer.padded`` once a padded
    batch only."""
    model, _ = _small()
    profiling.clear()
    with torch.profiler.profile(), torch.no_grad():
        model(_x((1, 1, 32, 32)))
        model(_x((1, 1, 30, 32)))
    got = profiling.recorded()
    profiling.clear()
    names = [s["name"] for s in got["spans"]]
    blocks = 4 + 3 + 1
    assert names.count("restormer.forward") == 2
    assert names.count("restormer.attention") == 2 * blocks
    assert names.count("restormer.ffn") == 2 * blocks
    assert got["counters"] == {"restormer.padded": 1}


@pytest.fixture
def small_network(monkeypatch):
    """``restormer_gray`` at the small widths, everywhere it is built; the
    trainer's log without TensorBoard, as on the card's machine (which
    has none), so the test does not pay TensorFlow's import."""
    monkeypatch.setitem(restormer.NETWORKS, "restormer_gray", SMALL)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


TRAIN = dict(crop=32, batch_size=2, steps_per_epoch=1, num_epochs=1,
             val_steps=1, tr_csv="split_tr.csv", va_csv="split_va.csv")


def test_trained_run_loads_back_and_sweeps(small_network, tmp_path):
    """``train-unet --network restormer_gray``: one step at a 32^2 crop;
    ``best.npz`` holds the state dict under its own names, which
    ``load_pretrained_unet`` reads into the model that ``predict_sweep``
    runs, giving model/best's (beta_hat, l1) and the reference's; a resumed
    run at learning rate 0 keeps those parameters, from model/best and
    from ``best.npz`` alone."""
    from wsunet_tpu_torch.cli import main
    from wsunet_tpu_torch.train import checkpoint as tck
    from wsunet_tpu_torch.train.train_unet import train_names
    from wsunet_tpu_torch.ws import load_pretrained_unet, predict_sweep
    from wsunet_tpu_torch.ws.unet_eval import predict_batch

    out = tmp_path / "runs"
    assert main(["train-unet", "--data", str(P128), "--output-dir",
                 str(out), "--device", "cpu", "--network", "restormer_gray",
                 "--config", json.dumps(TRAIN)]) == 0
    (run,) = (out / "LSBR").iterdir()
    assert json.loads((run / "config.json").read_text())["network"] == \
        "restormer_gray"
    best = tck.load_checkpoint(run, "best")["params"]
    params = tck.load_params(run)[0]
    assert sorted(params) == sorted(best)
    assert all(np.array_equal(params[k], best[k].numpy()) for k in best)

    model, config = load_pretrained_unet(out / "LSBR", run.name,
                                         device="cpu")
    assert isinstance(model, restormer.Restormer) and not model.training
    names = sorted(f"images/{p.name}" for p in (P128 / "images").glob(
        "*.png"))[:3]
    beta, l1 = predict_sweep(P128, names, model, 2, threads=1,
                             device="cpu")
    from wsunet_tpu_torch.io.imread import imread_gray_u8
    px = np.stack([imread_gray_u8(P128 / n) for n in names])
    fresh = get_model("restormer_gray")
    fresh.load_state_dict(best)
    wb, wl = predict_batch(fresh.eval(), px, device="cpu")
    np.testing.assert_array_equal(beta, wb.numpy())
    np.testing.assert_array_equal(l1, wl.numpy())
    # the sweep's answers are float32 (l1 about 16: an ulp is 2e-6)
    rb, rl = ref.ws_predict(best, px, "cpu")
    np.testing.assert_allclose(beta, rb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(l1, rl, rtol=2e-6, atol=0)

    # unet-eval finds the run under its own --model-dir and sweeps a
    # catalog with it
    data = tmp_path / "data"
    (data / "images").mkdir(parents=True)
    for n in names:
        shutil.copy(P128 / n, data / n)
    (data / "images" / "files.csv").write_text("\n".join(
        ["name,height,width"] + [f"{n},128,128" for n in names]) + "\n")
    assert main(["simulate", "--device", "cpu", "--data", str(data),
                 "--method", "LSBr", "--alphas", "0.1"]) == 0
    assert main(["unet-eval", "--device", "cpu", "--data", str(data),
                 "--model-dir", str(out), "--batch-size", "2",
                 "--results", str(tmp_path / "res")]) \
        == 0
    rows = (tmp_path / "res" / "estimation" / "ws_LSBR.csv").read_text()
    assert len(rows.strip().splitlines()) == 1 + 2 * len(names)

    tr = [f"images/{p.name}" for p in sorted((P128 / "images").glob(
        "*.png"))[:4]]
    cfg = {**TRAIN, "network": "restormer_gray", "learning_rate": 0.0,
           "resume": run.name}
    again = train_names(cfg, P128, tr, tr[:2], out, device="cpu")
    kept = tck.load_checkpoint(again, "best")["params"]
    assert all(torch.equal(kept[k], best[k]) for k in best)
    npz_only = tmp_path / "npz" / "LSBR" / run.name
    npz_only.mkdir(parents=True)
    shutil.copy(run / "best.npz", npz_only)
    again = train_names(cfg, P128, tr, tr[:2], tmp_path / "npz",
                        device="cpu")
    kept = tck.load_checkpoint(again, "best")["params"]
    assert all(torch.equal(kept[k], best[k]) for k in best)
