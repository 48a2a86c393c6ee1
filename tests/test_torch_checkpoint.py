"""Port parity: trained runs exported for the port
(``scripts/export_torch_weights.py``) and read back by
wsunet_tpu_torch (``train.checkpoint``, ``utils.registry``,
``ws.unet_eval.load_pretrained_unet``), against the JAX package restoring
the Orbax checkpoint.

The forward of a p128 cover: atol 1e-4 on the sigmoid output, the bound
``tests/test_torch_unet.py`` sets for the committed checkpoint.  The
committed exports must equal a fresh export array for array.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_p128 import P128, REPO, frame
from wsunet_tpu.models import get_model as jax_get_model
from wsunet_tpu.utils import registry as jax_registry
from wsunet_tpu.ws.unet_eval import load_pretrained_unet as jax_load
from wsunet_tpu_torch.train import load_config, load_params
from wsunet_tpu_torch.utils import registry
from wsunet_tpu_torch.utils.errors import UserError
from wsunet_tpu_torch.ws import load_pretrained_unet

RUNS = {
    "LSBR": "260819071329-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_",
    "HILLR": "260819120519-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_",
    "dropout": "260817015643-tpu-unet_2-grayscale_l1_lr_0.0001_dr_0.1",
}
COMMITTED = ("LSBR", "dropout", "HILLR")


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "scripts" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """A fresh export of the committed runs and the golden files."""
    out = tmp_path_factory.mktemp("weights")
    assert _exporter().main(["--out", str(out)]) == 0
    return out


def _cover():
    from wsunet_tpu_torch.io import imread_gray_u8
    img = imread_gray_u8(sorted((P128 / "images").glob("*.png"))[0])
    return (img.astype(np.float32) / 255.0)[None]


@pytest.mark.parametrize("method", sorted(RUNS))
def test_exported_run_forwards_as_jax_orbax(tmp_path, method):
    dst = _exporter().export_run(REPO / "models" / "unet" / method /
                                 RUNS[method], tmp_path)
    assert dst == tmp_path / method / RUNS[method]
    jmodel, variables, jconfig = jax_load(REPO / "models" / "unet" / method,
                                          RUNS[method])
    x = _cover()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x[..., None])))
    model, config = load_pretrained_unet(tmp_path / method, RUNS[method],
                                         device="cpu")
    assert config == jconfig and not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None])[:, 0].numpy()
    np.testing.assert_allclose(got, want[..., 0], atol=1e-4, rtol=0)
    assert np.abs(got - x).mean() < 0.05   # it predicts the cover


@pytest.mark.parametrize("method", COMMITTED)
def test_best_npz_has_the_flax_tree_keys(method):
    run_dir = REPO / "weights" / "unet" / method / RUNS[method]
    with np.load(run_dir / "best.npz") as npz:
        keys = {k: npz[k].shape for k in npz.files}
        assert all(npz[k].dtype == np.float32 for k in npz.files)
    config = load_config(run_dir)
    v = jax_get_model(config["network"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1), jnp.float32))
    flat = _exporter().flatten_tree(jax.tree.map(np.asarray, v["params"]))
    assert keys == {k: a.shape for k, a in flat.items()}
    assert sum(int(np.prod(s)) for s in keys.values()) == 1_861_697


@pytest.mark.parametrize("method", COMMITTED)
def test_committed_export_equals_a_fresh_one(fresh, method):
    committed = REPO / "weights" / "unet" / method / RUNS[method]
    new = fresh / "unet" / method / RUNS[method]
    assert json.loads((committed / "config.json").read_text()) == \
        json.loads((new / "config.json").read_text())
    with np.load(committed / "best.npz") as a, np.load(new / "best.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # and it is the Orbax checkpoint's params, unflattened
    _, variables, _ = jax_load(REPO / "models" / "unet" / method,
                               RUNS[method])
    tree, stats = load_params(committed)
    assert stats == {}
    jax.tree.map(np.testing.assert_array_equal, tree,
                 jax.tree.map(np.asarray, variables["params"]))


def test_committed_golden_equals_a_fresh_one(fresh):
    committed = REPO / "weights" / "golden" / "p128_lsbr.npz"
    with np.load(committed) as a, \
            np.load(fresh / "golden" / "p128_lsbr.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["pixels"].shape == (3, 64, 128, 128)
        assert str(a["run"]) == RUNS["LSBR"]


def test_committed_train_golden_equals_a_fresh_one(fresh):
    committed = REPO / "weights" / "golden" / "p128_train_step.npz"
    with np.load(committed) as a, \
            np.load(fresh / "golden" / "p128_train_step.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["pixels"].shape == (3, 4, 128, 128)
        assert str(a["run"]) == RUNS["LSBR"]
        assert a["draws/0/is_stego"][:3].any()
        assert not a["draws/0/is_stego"][:3].all()


B0_RUNS = [
    "260817154325-tpu-b0-alpha_mix0.1-0.05-0.01_grayscale_crossentropy_lr_"
    "2e-05_dr_0.2",
    "260818140316-tpu-b0-nostride-alpha_mix0.1-0.05-0.01_grayscale_"
    "crossentropy_lr_2e-05_dr_0.2",
]


@pytest.mark.parametrize("run", B0_RUNS)
def test_committed_b0_export_equals_a_fresh_one(fresh, run):
    """The B0 exports (parameters and, under ``batch_stats/``, the running
    statistics) equal a fresh export, and ``load_params`` gives back the
    Orbax checkpoint's two trees."""
    from wsunet_tpu.detect.b0_eval import load_pretrained_b0 as jax_load_b0

    committed = REPO / "weights" / "b0" / "LSBR" / run
    new = fresh / "b0" / "LSBR" / run
    assert load_config(committed) == load_config(new)
    with np.load(committed / "best.npz") as a, np.load(new / "best.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("batch_stats/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _, variables, _ = jax_load_b0(REPO / "models" / "b0" / "LSBR", run)
    params, stats = load_params(committed)
    jax.tree.map(np.testing.assert_array_equal, params,
                 jax.tree.map(np.asarray, variables["params"]))
    jax.tree.map(np.testing.assert_array_equal, stats,
                 jax.tree.map(np.asarray, dict(variables["batch_stats"])))


def test_committed_b0_golden_equals_a_fresh_one(fresh):
    committed = REPO / "weights" / "golden" / "p128_b0.npz"
    with np.load(committed) as a, \
            np.load(fresh / "golden" / "p128_b0.npz") as b, \
            np.load(REPO / "weights" / "golden" / "p128_lsbr.npz") as c:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert list(a["runs"]) == B0_RUNS
        assert (a["names"] == c["names"]).all()
        assert a["prob/ns-r-B0_mix0.1-0.05-0.01"].shape == (3, 64)


def test_committed_b0_train_golden_equals_a_fresh_one(fresh):
    committed = REPO / "weights" / "golden" / "p128_b0_train_step.npz"
    with np.load(committed) as a, \
            np.load(fresh / "golden" / "p128_b0_train_step.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["pixels"].shape == (4, 2, 128, 128)
        assert str(a["run"]) == B0_RUNS[0]
        assert a["live/draws/keep"].shape == (4, 1280)
        assert len(set(a["draws/0/alphas"].tolist())) == 2
    assert committed.stat().st_size < 1 << 20


def test_committed_filters_golden_equals_a_fresh_one(fresh):
    committed = REPO / "weights" / "golden" / "p128_filters.npz"
    with np.load(committed) as a, \
            np.load(fresh / "golden" / "p128_filters.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["mae/KB/none"].shape == (64,)
        assert a["color/wmae/AVG/2"].shape == (2, 8)


def test_committed_analyses_golden_equals_a_fresh_one(fresh):
    committed = REPO / "weights" / "golden" / "p128_analyses.npz"
    with np.load(committed) as a, \
            np.load(fresh / "golden" / "p128_analyses.npz") as b, \
            np.load(REPO / "weights" / "golden" / "p128_lsbr.npz") as c:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["names"] == c["names"]).all()
        assert list(a["correlation_models"]) == [
            "1", "AVG9", "AVG", "KB", "UNet_dropout_l1", "UNet_LSBR_l1ws",
            "UNet_HILLR_l1ws"]
        assert list(a["unet_runs"]) == [RUNS[m] for m in ("dropout", "LSBR",
                                                          "HILLR")]
        assert a["correlation/KB"].shape == (64,)
        assert sorted(set(a["boxes/Type"])) == ["AVG", "KB", "UNet_l1",
                                                "UNet_l1ws"]
        assert a["saliency/patches"].shape == (4, 17, 17)
        assert a["diff/UNet"].shape == (2, 126, 126)
    assert committed.stat().st_size < 1 << 20


def _fake_run(root, method, name, loss, params=True, **extra):
    run = root / method / name
    run.mkdir(parents=True)
    (run / "config.json").write_text(json.dumps(
        {"stego_method": method, "loss": loss, "network": "unet_2",
         "alpha": 0.4, **extra}))
    if params:
        np.savez(run / "best.npz", x=np.zeros(1, np.float32))
        (run / "model" / "best").mkdir(parents=True)   # JAX's marker
    return run


def test_registry_matches_jax_and_raises(tmp_path):
    _fake_run(tmp_path, "LSBR", "a", "l1ws")
    _fake_run(tmp_path, "LSBR", "b", "l1ws", alpha=[0.1, 0.05])
    _fake_run(tmp_path, "LSBR", "c", "l1", params=False)
    _fake_run(tmp_path, "LSBR", "d", "l1", debug=True)
    _fake_run(tmp_path, "dropout", "e", "l1")
    got = frame(registry.scan_models(tmp_path, "LSBR")).sort_values(
        "model_name")
    want = jax_registry.scan_models(tmp_path, "LSBR").sort_values(
        "model_name")
    assert got.reset_index(drop=True).equals(want.reset_index(drop=True))
    assert list(got["model_name"]) == ["a", "b"]
    assert got["alpha"].tolist() == [0.4, "mix0.1-0.05"]
    assert registry.get_model_name(tmp_path, "dropout") == "e"
    assert registry.get_model_name(tmp_path, "LSBR", alpha=0.4) == "a"
    with pytest.raises(UserError, match="multiple models"):
        registry.get_model_name(tmp_path, "LSBR", loss="l1ws")
    with pytest.raises(UserError, match="no model"):
        registry.get_model_name(tmp_path, "HILLR")
    with pytest.raises(UserError, match="no model"):
        registry.get_model_name(tmp_path, "LSBR", loss="l1")
    assert registry.get_model_name(REPO / "weights" / "unet", "LSBR") == \
        RUNS["LSBR"]


def test_load_params_unflattens_and_missing_runs_raise(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    np.savez(run / "best.npz", **{"a/b/kernel": np.ones((2, 3), np.float32),
                                  "a/b/bias": np.zeros(3, np.float32),
                                  "top": np.arange(2, dtype=np.float32)})
    tree, stats = load_params(run)
    assert stats == {}
    assert set(tree) == {"a", "top"} and set(tree["a"]["b"]) == \
        {"kernel", "bias"}
    assert tree["a"]["b"]["kernel"].shape == (2, 3)
    with pytest.raises(FileNotFoundError, match="export_torch_weights"):
        load_params(tmp_path)
    with pytest.raises(UserError, match="config.json"):
        load_pretrained_unet(tmp_path, "nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(UserError, match="device='cpu'"):
            load_pretrained_unet(REPO / "weights" / "unet" / "LSBR",
                                 RUNS["LSBR"])
    assert not any(p.name == "models" for p in pathlib.Path(
        REPO / "weights").rglob("*"))
