"""Port parity: the trained B0 runs and the B0 detection runs
(``detect.b0_eval``: ``load_pretrained_b0``, ``infer_b0``,
``score_sweep``, ``run``; ``detector-eval`` and ``roc --b0``) against the
JAX package's, on the CPU.  The model itself is held in
tests/test_torch_b0.py.

Tolerances, and why: P(stego) of the trained runs |d| <= 1e-4.  The
no-stem-stride run's activations grow to about 200 in the last stages;
its logits (up to 100) then differ from JAX's by about 3e-6 relative,
which moves a P(stego) near 0.5 by up to 3.6e-5 (measured on the golden
images; the strided run 4.5e-6).  The ROC and AUC tables of ``roc --b0``
equal JAX's.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from torch_p128 import REPO, make_catalog, run_without_host_packages
from wsunet_tpu.cli import b0_label as jax_b0_label
from wsunet_tpu.cli import main as jax_main
from wsunet_tpu_torch.cli import b0_label
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.detect import infer_b0, load_pretrained_b0
from wsunet_tpu_torch.detect.b0_eval import b0_in_channels, score_sweep
from wsunet_tpu_torch.train import load_config
from wsunet_tpu_torch.utils.errors import UserError

GOLDEN = REPO / "weights" / "golden"
PORT_B0 = REPO / "weights" / "b0"
JAX_B0 = REPO / "models" / "b0"
P_ATOL = 1e-4
ALPHAS = ["0.1", "0.01"]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN / "p128_b0.npz") as g, \
            np.load(GOLDEN / "p128_lsbr.npz") as g0:
        out = {k: g[k] for k in g.files}
        assert (g0["names"] == out["names"]).all()
        out["pixels"] = g0["pixels"]
    return out


@pytest.mark.parametrize("index", [0, 1])
def test_trained_run_matches_golden(golden, index):
    """Both committed LSBR runs, 8 images of each set (covers, alpha 0.1,
    alpha 0.01), against the JAX package's P(stego)."""
    run, label = str(golden["runs"][index]), str(golden["labels"][index])
    model, config = load_pretrained_b0(PORT_B0 / "LSBR", run, device="cpu")
    assert config == load_config(JAX_B0 / "LSBR" / run)
    assert b0_label(config) == jax_b0_label(config) == label
    assert not model.training
    assert model.conv_stem.in_channels == b0_in_channels(config) + \
        int(config["parity_features"])
    got = np.stack([infer_b0(model, torch.from_numpy(p[:8]),
                             use_lsbr_reference=config["lsbr_reference"],
                             device="cpu").numpy()
                    for p in golden["pixels"]])
    np.testing.assert_allclose(got, golden[f"prob/{label}"][:, :8],
                               rtol=0, atol=P_ATOL)


@pytest.mark.parametrize("config", [
    {}, {"no_stem_stride": True, "lsbr_reference": True},
    {"alpha": [0.1, 0.05], "stego_method": "HILLR"}, {"alpha": 0.01},
    {"grayscale": False, "demosaic_oracle": True, "lsbr_reference": True}])
def test_labels_and_channels_match_jax(config):
    assert b0_label(config) == jax_b0_label(config)
    jax_in = (1 if config.get("grayscale", True) else 3) + \
        (3 if config.get("demosaic_oracle") else 0) + \
        (1 if config.get("lsbr_reference") else 0)
    assert b0_in_channels(config) == jax_in


def test_missing_run_and_device_rules(tmp_path):
    with pytest.raises(UserError, match="config.json"):
        load_pretrained_b0(tmp_path, "nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(UserError, match="device='cpu'"):
            load_pretrained_b0(PORT_B0 / "LSBR", "x")


def test_score_sweep_gives_nan_for_a_corrupt_file(golden, tmp_path):
    """The name-based sweep (what the card runs from .npy files): a NaN
    row for a corrupt file, the others as ``infer_b0`` gives them."""
    run = str(golden["runs"][0])
    model, _ = load_pretrained_b0(PORT_B0 / "LSBR", run, device="cpu")
    (tmp_path / "images").mkdir()
    names = [f"images/{i:02d}.npy" for i in range(6)]
    for name, img in zip(names, golden["pixels"][0]):
        np.save(tmp_path / name, img)
    (tmp_path / names[3]).write_bytes(b"not an array")

    def detect(x):
        return infer_b0(model, x, device="cpu")

    from wsunet_tpu_torch.data import pipeline
    pipeline.clear_decode_cache()
    try:
        got = score_sweep(tmp_path, names, detect, 4, reader=np.load,
                          device="cpu")
    finally:
        pipeline.clear_decode_cache()
    assert got.dtype == np.float32 and np.isnan(got[3])
    keep = np.arange(6) != 3
    np.testing.assert_allclose(
        got[keep], golden[f"prob/{golden['labels'][0]}"][0, :6][keep],
        rtol=0, atol=P_ATOL)


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return make_catalog(tmp_path_factory.mktemp("p128"), n=8,
                        alphas=tuple(map(float, ALPHAS)))


@pytest.fixture(scope="module")
def cli_outputs(cat, tmp_path_factory):
    """``detector-eval`` (the default, strided configuration) and ``roc
    --b0`` (both configurations) of both packages on the catalog."""
    out = {}
    for pkg, main, b0_dir in (("jax", jax_main, JAX_B0),
                              ("torch", torch_main, PORT_B0)):
        res = tmp_path_factory.mktemp(pkg)
        dev = ["--device", "cpu"] if pkg == "torch" else []
        common = ["--data", str(cat), "--results", str(res)] + dev
        assert main(["detector-eval", *common, "--model-dir",
                     str(b0_dir)]) in (0, None)
        main(["roc", *common, "--b0", "--b0-model-dir", str(b0_dir),
              "--models", "KB", "--alphas", *ALPHAS])
        out[pkg] = res / "detection"
    return out


def _assert_b0_csv_matches(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == 24
    for col in got.columns:
        if col == "output":
            np.testing.assert_allclose(got[col], want[col], rtol=0,
                                       atol=P_ATOL)
        elif col == "prediction":
            clear = (want["output"] - 0.5).abs() > P_ATOL
            assert (got[col][clear] == want[col][clear]).all()
        else:
            assert got[col].astype(str).tolist() == \
                want[col].astype(str).tolist(), col


def _assert_roc_b0_table_equal(got, want, name):
    pd.testing.assert_frame_equal(got, want)
    if name.startswith("auc"):
        assert got["model_name"].tolist() == [
            "B0_mix0.1-0.05-0.01", "KB", "ns-r-B0_mix0.1-0.05-0.01"]


@pytest.mark.parametrize("name", ["b0.csv"])
def test_detector_eval_csv_matches_jax(cli_outputs, name):
    _assert_b0_csv_matches(pd.read_csv(cli_outputs["torch"] / name),
                           pd.read_csv(cli_outputs["jax"] / name))


@pytest.mark.parametrize("name", [f"auc_{ALPHAS[-1]}.csv",
                                  f"roc_{ALPHAS[-1]}.csv"])
def test_roc_b0_tables_equal_jax(cli_outputs, name):
    _assert_roc_b0_table_equal(pd.read_csv(cli_outputs["torch"] / name),
                               pd.read_csv(cli_outputs["jax"] / name), name)


@pytest.mark.parametrize("name", ["b0.csv", f"auc_{ALPHAS[-1]}.csv",
                                  f"roc_{ALPHAS[-1]}.csv"])
def test_b0_commands_without_host_packages_match_jax(cat, cli_outputs,
                                                     tmp_path, name):
    """``detector-eval`` and ``roc --b0`` in a fresh interpreter where
    pandas, PIL, cv2 and matplotlib cannot be imported write the JAX CLI's
    files (the comparisons above)."""
    common = ["--data", cat, "--results", tmp_path, "--device", "cpu"]
    if name == "b0.csv":
        run_without_host_packages(["detector-eval", *common, "--model-dir",
                                   PORT_B0], tmp_path)
        _assert_b0_csv_matches(
            pd.read_csv(tmp_path / "detection" / name),
            pd.read_csv(cli_outputs["jax"] / name))
        return
    run_without_host_packages(["roc", *common, "--b0", "--b0-model-dir",
                               PORT_B0, "--models", "KB", "--alphas",
                               *ALPHAS], tmp_path)
    _assert_roc_b0_table_equal(pd.read_csv(tmp_path / "detection" / name),
                               pd.read_csv(cli_outputs["jax"] / name), name)


def test_roc_b0_skips_a_missing_configuration(cat, tmp_path, capsys):
    """Without runs, both B0 configurations are skipped with a note (as in
    JAX) and the WS rows are written."""
    assert torch_main(["roc", "--data", str(cat), "--results", str(tmp_path),
                       "--device", "cpu", "--b0", "--b0-model-dir",
                       str(tmp_path), "--models", "KB", "--alphas",
                       "0.1"]) == 0
    err = capsys.readouterr().err
    assert "skipping B0 ns=False r=False" in err
    assert "skipping B0 ns=True r=True" in err
    auc = pd.read_csv(tmp_path / "detection" / "auc_0.1.csv")
    assert auc["model_name"].tolist() == ["KB"]


def test_exported_config_is_the_checkpoints():
    for run in (PORT_B0 / "LSBR").iterdir():
        assert json.loads((run / "config.json").read_text()) == \
            load_config(JAX_B0 / "LSBR" / run.name)
