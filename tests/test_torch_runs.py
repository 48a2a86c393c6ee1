"""Port parity: the catalog runs and the CLI (wsunet_tpu_torch.ws.ws_run,
unet_run, ``python -m wsunet_tpu_torch ws-eval | unet-eval | roc``)
against the JAX package's (``python -m wsunet_tpu ...``), on the CPU, over
12 p128 covers with LSBr stego at alpha 0.1 and 0.01 made by the JAX
package's ``simulate``.  The port reads the exported runs under
``weights/unet``; JAX the Orbax checkpoints under ``models/unet``.

The CLI also runs in a fresh interpreter where pandas, PIL, cv2,
matplotlib and seaborn cannot be imported (the card's machine has none),
and writes the same files; ``utils.table`` reads and writes the JAX CLI's
files byte for byte as pandas does.

CSV files are compared by parsed value: the same rows and columns in the
same order, text columns equal, beta_hat within rtol 1e-4 / atol 1e-6 for
the named filters (B2's tolerance), rtol 1e-4 / atol 1e-5 for -sca
(tests/test_torch_hill_sca.py), |d| <= 1e-5 for the U-Net's beta_hat and
relative 1e-4 for its l1 (f32 conv sums in another order); the ROC and
AUC tables equal.
"""

import shutil

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from torch_p128 import (REPO, frame, make_catalog,
                        run_without_host_packages)
from wsunet_tpu.cli import main as jax_main
from wsunet_tpu.ws import unet_run as jax_unet_run
from wsunet_tpu.ws import ws_run as jax_ws_run
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.data import pipeline, precovers
from wsunet_tpu_torch.ops import fused_reflect_conv
from wsunet_tpu_torch.utils.errors import UserError
from wsunet_tpu_torch.utils.registry import get_model_name
from wsunet_tpu_torch.ws import (load_pretrained_unet, predict_sweep,
                                 unet_run, ws_run)

JAX_MODELS = REPO / "models" / "unet"
PORT_MODELS = REPO / "weights" / "unet"
ALPHAS = ["0.1", "0.01"]
# beta_hat tolerance by model_name: (rtol, atol)
TOL = {"KB": (1e-4, 1e-6), "KB-w": (1e-4, 1e-6), "AVG": (1e-4, 1e-6),
       "KB-sca": (1e-4, 1e-5)}
UNET_ATOL = 1e-5


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return make_catalog(tmp_path_factory.mktemp("p128"), n=12,
                        alphas=tuple(map(float, ALPHAS)))


def _assert_rows_match(got: pd.DataFrame, want: pd.DataFrame):
    """Same columns, rows and text; numbers within the stated bounds."""
    got, want = frame(got), frame(want)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    for col in got.columns:
        g, w = got[col], want[col]
        if col == "beta_hat":
            models = want["model_name"] if "model_name" in want else \
                pd.Series("UNet", index=want.index)
            for model in models.unique():
                sel = (models == model).to_numpy()
                rtol, atol = TOL.get(model, (0.0, UNET_ATOL))
                np.testing.assert_allclose(g[sel], w[sel], rtol=rtol,
                                           atol=atol, err_msg=model)
        elif col == "l1":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
        elif pd.api.types.is_numeric_dtype(w) and \
                pd.api.types.is_numeric_dtype(g):
            np.testing.assert_array_equal(g.to_numpy(), w.to_numpy(),
                                          err_msg=col)
        else:
            assert g.astype(str).tolist() == w.astype(str).tolist(), col


@pytest.mark.parametrize("model", ["KB", "KB-w", "KB-sca", "AVG", "UNet"])
@pytest.mark.parametrize("stego", [None, "0.1"])
def test_ws_run_matches_jax(cat, model, stego):
    kw = dict(input_dir=cat, stego_method="LSBR" if stego else None,
              alpha=float(stego) if stego else None, model_name=model,
              batch_size=5)
    if model == "UNet":
        run = "260819071329-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_"
        kw["model_name"] = run
        got = ws_run(model_path=PORT_MODELS / "LSBR", device="cpu", **kw)
        want = jax_ws_run(model_path=JAX_MODELS / "LSBR", **kw)
    else:
        got = ws_run(device="cpu", **kw)
        want = jax_ws_run(**kw)
    assert len(got) == 12
    _assert_rows_match(got, want)


def test_unet_run_matches_jax(cat):
    got = frame(unet_run(cat, PORT_MODELS, "LSBR", batch_size=5,
                         device="cpu"))
    want = jax_unet_run(cat, JAX_MODELS, "LSBR", batch_size=5)
    assert len(got) == 36 and got["beta_hat"].notna().all()
    _assert_rows_match(got, want)


@pytest.fixture(scope="module")
def cli_outputs(cat, tmp_path_factory):
    """The three subcommands of both packages on the catalog."""
    out = {}
    for pkg, main, models in (("jax", jax_main, JAX_MODELS),
                              ("torch", torch_main, PORT_MODELS)):
        res = tmp_path_factory.mktemp(pkg)
        dev = ["--device", "cpu"] if pkg == "torch" else []
        common = ["--data", str(cat), "--results", str(res)] + dev
        assert main(["ws-eval", *common, "--models", "KB", "KB-w", "KB-sca",
                     "UNet", "--model-dir", str(models), "--alphas",
                     *ALPHAS]) == 0
        assert main(["unet-eval", *common, "--model-dir", str(models)]) \
            in (0, None)
        main(["roc", *common, "--unet-model-dir", str(models), "--alphas",
              *ALPHAS])
        out[pkg] = res
    return out


@pytest.mark.parametrize("name", ["estimation/ws_sweep_LSBR.csv",
                                  "estimation/ws_LSBR.csv"])
def test_cli_estimation_csv_matches_jax(cli_outputs, name):
    got = pd.read_csv(cli_outputs["torch"] / name)
    want = pd.read_csv(cli_outputs["jax"] / name)
    _assert_rows_match(got, want)
    if "sweep" in name:
        assert sorted(got["model_name"].unique()) == [
            "KB", "KB-sca", "KB-w", "UNet_l1", "UNet_l1ws_LSBR"]
        assert len(got) == 5 * 36


@pytest.mark.parametrize("name", [f"detection/auc_{ALPHAS[-1]}.csv",
                                  f"detection/roc_{ALPHAS[-1]}.csv"])
def test_cli_roc_tables_equal_jax(cli_outputs, name):
    got = pd.read_csv(cli_outputs["torch"] / name)
    want = pd.read_csv(cli_outputs["jax"] / name)
    pd.testing.assert_frame_equal(got, want)
    if "auc" in name:
        assert got["model_name"].tolist() == ["AVG", "KB", "KB-sca",
                                              "KB-w", "UNet"]
    png = cli_outputs["torch"] / f"detection/roc_{ALPHAS[-1]}.png"
    assert png.stat().st_size > 0


@pytest.fixture(scope="module")
def blocked_outputs(cat, tmp_path_factory):
    """``cli_outputs``' three port commands, each in a fresh interpreter
    without pandas, PIL, cv2, matplotlib or seaborn; their stderr."""
    res = tmp_path_factory.mktemp("blocked")
    common = ["--data", cat, "--results", res, "--device", "cpu"]
    errs = [run_without_host_packages(
        [cmd, *common, *extra], res).stderr for cmd, extra in (
            ("ws-eval", ["--models", "KB", "KB-w", "KB-sca", "UNet",
                         "--model-dir", PORT_MODELS, "--alphas", *ALPHAS]),
            ("unet-eval", ["--model-dir", PORT_MODELS]),
            ("roc", ["--unet-model-dir", PORT_MODELS, "--alphas",
                     *ALPHAS]))]
    return res, errs


@pytest.mark.parametrize("name", ["estimation/ws_sweep_LSBR.csv",
                                  "estimation/ws_LSBR.csv",
                                  f"detection/auc_{ALPHAS[-1]}.csv",
                                  f"detection/roc_{ALPHAS[-1]}.csv"])
def test_cli_without_host_packages_matches_jax(cli_outputs, blocked_outputs,
                                               name):
    """Where pandas, PIL, cv2 and matplotlib cannot be imported, ``ws-eval``,
    ``unet-eval`` and ``roc`` write the JAX CLI's files (the comparisons
    above); ``roc`` says on stderr that it drew no figure."""
    res, errs = blocked_outputs
    got = pd.read_csv(res / name)
    want = pd.read_csv(cli_outputs["jax"] / name)
    if name.startswith("detection"):
        pd.testing.assert_frame_equal(got, want)
    else:
        _assert_rows_match(got, want)
    assert f"roc_{ALPHAS[-1]}.png not drawn" in errs[2]
    assert not (res / "detection" / f"roc_{ALPHAS[-1]}.png").exists()


@pytest.mark.parametrize("name", ["estimation/ws_sweep_LSBR.csv",
                                  "estimation/ws_LSBR.csv",
                                  f"detection/auc_{ALPHAS[-1]}.csv",
                                  f"detection/roc_{ALPHAS[-1]}.csv"])
def test_table_round_trip_equals_pandas_on_the_jax_cli_outputs(cli_outputs,
                                                              name):
    """``utils.table.read_csv`` then ``to_csv`` writes what pandas writes
    for the JAX CLI's files, byte for byte, and reads the same frame."""
    from wsunet_tpu_torch.utils import table

    path = cli_outputs["jax"] / name
    t, df = table.read_csv(path), pd.read_csv(path)
    assert t.to_csv() == df.to_csv(index=False)
    pd.testing.assert_frame_equal(frame(t), df)


def test_simulate_without_host_packages_writes_the_ports_files(cat,
                                                              tmp_path):
    """``simulate`` where PIL and pandas cannot be imported writes the
    same PNG bytes as in a process that has them (the port's own writer
    and draws) and the JAX CLI's ``files.csv``; PIL reads each stego image
    as the port's reader does."""
    from wsunet_tpu_torch.io.png import read_png

    roots = {}
    for side in ("blocked", "inproc"):
        roots[side] = tmp_path / side
        (roots[side] / "images").mkdir(parents=True)
        for f in (cat / "images").iterdir():
            shutil.copyfile(f, roots[side] / "images" / f.name)
    args = ["simulate", "--method", "LSBr", "--alphas", *ALPHAS, "--device",
            "cpu"]
    run_without_host_packages([*args, "--data", roots["blocked"]], tmp_path)
    assert torch_main([*args, "--data", str(roots["inproc"])]) == 0
    for alpha in ALPHAS:
        sub = f"stego_LSBr_alpha_{alpha}_independent_images"
        pd.testing.assert_frame_equal(
            pd.read_csv(roots["blocked"] / sub / "files.csv"),
            pd.read_csv(cat / sub / "files.csv"))
        pngs = sorted((roots["blocked"] / sub).glob("*.png"))
        assert len(pngs) == 12
        for p in pngs:
            assert p.read_bytes() == \
                (roots["inproc"] / sub / p.name).read_bytes()
            with Image.open(p) as im:
                np.testing.assert_array_equal(np.array(im), read_png(p))


def test_cli_errors_are_one_line(cat, tmp_path, capsys):
    base = ["--data", str(cat), "--results", str(tmp_path), "--device",
            "cpu"]
    with pytest.raises(SystemExit, match="^unet-eval: no model for"):
        torch_main(["unet-eval", *base, "--model-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="^detector-eval: no model for"):
        torch_main(["detector-eval", *base, "--model-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="^ws-eval: no files.csv"):
        torch_main(["ws-eval", "--data", str(tmp_path), "--results",
                    str(tmp_path), "--device", "cpu"])
    # a missing UNet is skipped with a note, as in JAX
    assert torch_main(["ws-eval", *base, "--models", "KB", "UNet",
                       "--model-dir", str(tmp_path), "--alphas", "0.1"]) == 0
    assert "skipping UNet l1/dropout" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        torch_main(["filters-eval"])   # no card (or no ./data): one line
    # roc --b0, OLS and colour planes are served since the B0 slice
    # (tests/test_torch_b0.py, tests/test_torch_ols.py); colour OLS on this
    # grayscale catalog has equal planes, so exactly singular equations
    with pytest.raises(SystemExit, match="^ws-eval: OLS: the normal "
                                         "equations are singular"):
        torch_main(["ws-eval", *base, "--models", "OLS", "--channels", "0",
                    "3"])
    with pytest.raises(UserError, match="singular"):
        ws_run(cat, None, None, "OLS", channels=(0, 3), device="cpu")


def test_fast_conv_reaches_b1_from_the_cli(cat, tmp_path, monkeypatch):
    """``--fast-conv`` (``fast_conv=True`` of ``unet_run`` and ``ws_run``)
    sends every 3x3 conv of the U-Net through B1's wrapper, 10 calls a
    forward (its plain version on the CPU), with the rows of the cuDNN
    route."""
    select = dict(take_num_images=5, device="cpu")
    want = unet_run(cat, PORT_MODELS, "LSBR", **select)
    name = get_model_name(PORT_MODELS, "LSBR")
    want_ws = ws_run(cat, "LSBR", 0.1, name, model_path=PORT_MODELS / "LSBR",
                     **select)
    calls = []
    plain = fused_reflect_conv.conv3x3_reflect_fused_plain
    monkeypatch.setattr(fused_reflect_conv, "conv3x3_reflect_fused_plain",
                        lambda *a: calls.append(1) or plain(*a))
    assert torch_main(["unet-eval", "--data", str(cat), "--results",
                       str(tmp_path), "--device", "cpu", "--take", "5",
                       "--model-dir", str(PORT_MODELS), "--fast-conv"]) == 0
    got = pd.read_csv(tmp_path / "estimation" / "ws_LSBR.csv")
    # one batch of 8 for the 5 covers and one for the first 5 stego
    assert len(got) == 10 and len(calls) == 10 * 2
    _assert_rows_match(got, pd.read_csv(
        _csv(want, tmp_path / "want.csv")))
    got_ws = ws_run(cat, "LSBR", 0.1, name, model_path=PORT_MODELS / "LSBR",
                    fast_conv=True, **select)
    assert len(calls) == 10 * 3
    _assert_rows_match(got_ws, want_ws)


def _csv(df, path):
    frame(df).to_csv(path, index=False)
    return path


def test_predict_sweep_gives_nan_for_a_corrupt_image(cat, tmp_path):
    """The U-Net sweep over image names: a file that fails to decode is a
    NaN row, the other rows are those of ``unet_run``; a second pass starts
    from the device cache and gives the same numbers."""
    bad = tmp_path / "cat"
    shutil.copytree(cat / "images", bad / "images")
    (bad / "images" / "6_02.png").write_bytes(b"not a png")
    names = list(precovers(bad)["name"])
    model, _ = load_pretrained_unet(PORT_MODELS / "LSBR",
                                    get_model_name(PORT_MODELS, "LSBR"),
                                    device="cpu")
    pipeline.clear_decode_cache()
    try:
        beta, l1 = predict_sweep(bad, names, model, 8, device="cpu")
        # the batch with the failed decode is never cached
        assert len(pipeline._DEVICE_CACHE) == 1
        again = predict_sweep(bad, names, model, 8, device="cpu")
    finally:
        pipeline.clear_decode_cache()
    want = unet_run(cat, PORT_MODELS, "LSBR", eval_methods=(),
                    device="cpu")
    assert beta.dtype == l1.dtype == np.float32 and beta.shape == (12,)
    assert np.isnan(beta[2]) and np.isnan(l1[2])
    keep = np.arange(12) != 2
    np.testing.assert_allclose(beta[keep], want["beta_hat"][keep],
                               rtol=0, atol=UNET_ATOL)
    np.testing.assert_allclose(l1[keep], want["l1"][keep], rtol=1e-4)
    np.testing.assert_array_equal(again[0], beta)
    np.testing.assert_array_equal(again[1], l1)
