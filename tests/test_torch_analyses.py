"""Port parity of the analyses (wsunet_tpu_torch.analyses: correlation,
error boxes, difference images; ``python -m wsunet_tpu_torch correlation |
error-boxes | contour``) against the JAX package's, on the CPU, over 8
p128 covers with LSBr stego at alpha 1.0 (``correlation``'s default) made
by the JAX package's ``simulate``.  The port reads the exported runs under
``weights/unet``, JAX the Orbax checkpoints under ``models/unet``; one JAX
CLI run of each analysis serves every case that reads it (its per-pair
rows and populations are captured on the way).

Bounds, and why:

- ``pair_correlation`` and the bucket statistics (``box_stats``) are the
  same numpy arithmetic on the same arrays: bit for bit.
- correlation of a named filter: rtol 1e-5 (``filter_predict``'s f32 conv
  sums its taps in another order than XLA's: an ulp of a prediction).
  Of a U-Net: rtol 1e-4, the U-Net bound since the first slice.
- p-values: log p at rtol 1e-3, 0 equal to 0.  At t of about 100, log p
  moves by t^2 times the correlation's relative error, so a plain rtol on
  p would hold the port to far more than its correlation.
- error boxes: KB's and AVG's residuals on integer pixels are exact in
  f32 (taps of quarters and eighths), so the buckets are JAX's; filter
  statistics at rtol 1e-5, U-Net statistics at rtol 1e-4 with the
  U-Net's per-pixel bound as atol (below): a bucket's minimum is one
  residual near 0, where 3.8e-6 is 4% of 9.5e-5.
- the CSVs: the port's CLI, in a process where pandas, PIL, cv2,
  matplotlib and seaborn cannot be imported, writes JAX's
  ``correlation.csv`` and ``ae_boxes_3.csv`` byte for byte when given
  JAX's per-pair rows and populations (``blocked_outputs``); on its own
  numbers the header and labels are JAX's bytes and the numbers are held
  as above, and each figure not drawn is named on stderr.
- difference images: KB at atol 1e-4.  Not bit for bit: the prediction
  is a conv of x / 255 (values up to 1, an f32 ulp of 6e-8) times 255,
  and no plain order of the 9 taps reproduces XLA's CPU conv (the best
  sequential order matches it on 83% of the pixels), so each ulp of the
  sum is 1.5e-5 of the image; 6.1e-5 seen.  The LSBR U-Net at 2.55e-4:
  1e-6 of its 0..1 sigmoid output, which 13 f32 layers sum in another
  order, times 255 (7.6e-5 seen here, 1.07e-4 on the card).
"""

import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import wsunet_tpu.analyses as jax_analyses
from torch_p128 import (LOAD_TABLE, REPO, frame, make_catalog,
                        run_without_host_packages, save_columns)
from wsunet_tpu.analyses import contour as jax_contour
from wsunet_tpu.analyses import correlation as jax_correlation
from wsunet_tpu.analyses import error_boxes as jax_boxes
from wsunet_tpu.cli import main as jax_main
from wsunet_tpu_torch.analyses import (bucket_quantiles, difference_image,
                                       pair_correlation, plot_contour,
                                       run_correlation, run_error_boxes)
from wsunet_tpu_torch.analyses import error_boxes
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.ops import fused_reflect_conv
from wsunet_tpu_torch.utils.errors import UserError

JAX_MODELS = REPO / "models" / "unet"
PORT_MODELS = REPO / "weights" / "unet"
FILTER_RTOL, UNET_RTOL, LOG_P_RTOL = 1e-5, 1e-4, 1e-3
KB_DIFF_ATOL = 1e-4
UNET_DIFF_ATOL = 2.55e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    """8 covers, LSBr stego at alpha 1.0, and a split_te.csv of the
    covers (error-boxes' default split)."""
    root = make_catalog(tmp_path_factory.mktemp("p128"), n=8, alphas=(1.0,))
    shutil.copyfile(root / "images" / "files.csv", root / "split_te.csv")
    return root


def _capturing(module, name, store):
    """``module.name`` wrapped to record its arguments and result."""
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        store.append((args, kwargs, out))
        return out
    return wrapper


@pytest.fixture(scope="module")
def jax_runs(cat, tmp_path_factory):
    """The JAX CLI's correlation, error-boxes and contour outputs, with
    ``run_correlation``'s result and ``bucket_quantiles``' populations."""
    out = tmp_path_factory.mktemp("jax")
    corr, boxes = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_analyses, "run_correlation", _capturing(
        jax_analyses, "run_correlation", corr))
    mp.setattr(jax_boxes, "bucket_quantiles", _capturing(
        jax_boxes, "bucket_quantiles", boxes))
    try:
        base = ["--data", str(cat), "--results", str(out), "--model-dir",
                str(JAX_MODELS)]
        assert jax_main(["correlation", *base]) == 0
        assert jax_main(["error-boxes", *base]) == 0
        assert jax_main(["contour", *base, "--image",
                         "images/" + _first_cover(cat)]) == 0
    finally:
        mp.undo()
    (_, _, (res, agg)), = corr
    (args, _, table), = boxes
    return {"dir": out, "rows": res, "agg": agg, "populations": args[0],
            "boxes": table}


def _first_cover(cat):
    return sorted(p.name for p in (cat / "images").glob("*.png"))[0]


def _rtol(label):
    return UNET_RTOL if label.startswith("UNet") else FILTER_RTOL


def _assert_correlation_rows(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    for col in ("name_c", "name_s", "model_name"):
        assert got[col].tolist() == want[col].tolist()
    for label in want["model_name"].unique():
        sel = (want["model_name"] == label).to_numpy()
        np.testing.assert_allclose(got["correlation"][sel],
                                   want["correlation"][sel],
                                   rtol=_rtol(label), err_msg=label)
        _assert_log_p(got["p-value"][sel], want["p-value"][sel], label)


def _assert_log_p(got, want, label=""):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert ((got == 0) == (want == 0)).all(), label
    nz = want != 0
    np.testing.assert_allclose(np.log(got[nz]), np.log(want[nz]),
                               rtol=LOG_P_RTOL, err_msg=label)


def test_pair_correlation_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x_c = rng.integers(0, 256, (40, 50)).astype(np.float32)
    x_s = x_c + rng.integers(-1, 2, x_c.shape).astype(np.float32)
    x_hat = (x_c[1:-1, 1:-1] + rng.normal(0, 2, (38, 48))).astype(
        np.float32)
    for orthodox in (False, True):
        assert pair_correlation(x_c, x_s, x_hat, orthodox) == \
            jax_correlation.pair_correlation(x_c, x_s, x_hat, orthodox)


@pytest.mark.parametrize("fast_conv", [False, True])
def test_run_correlation_matches_jax(cat, jax_runs, fast_conv):
    """Per-pair rows of the filters and the three trained U-Nets, and the
    median table; ``fast_conv=True`` takes B1's plain version here."""
    fused_reflect_conv.reset_launches()
    res, agg = run_correlation(cat, model_dir=PORT_MODELS,
                               fast_conv=fast_conv, batch_size=3,
                               device="cpu")
    assert fused_reflect_conv.launches == 0
    want = jax_runs["rows"]
    assert want["model_name"].unique().tolist() == [
        "1", "AVG9", "AVG", "KB", "UNet_dropout_l1", "UNet_LSBR_l1ws",
        "UNet_HILLR_l1ws"]
    assert len(want) == 7 * 8
    _assert_correlation_rows(frame(res), want)
    assert agg.columns == [""] + list(jax_runs["agg"].columns)
    assert list(agg[""]) == list(jax_runs["agg"].index)


def test_cli_correlation_csv_matches_jax(cat, jax_runs, tmp_path):
    assert torch_main(["correlation", "--data", str(cat), "--results",
                       str(tmp_path), "--model-dir", str(PORT_MODELS),
                       "--device", "cpu"]) == 0
    rel = "estimation/correlation.csv"
    got = pd.read_csv(tmp_path / rel, index_col=0)
    want = pd.read_csv(jax_runs["dir"] / rel, index_col=0)
    assert list(got.index) == list(want.index) == ["correlation", "p-value"]
    assert list(got.columns) == list(want.columns)
    for label in want.columns:
        np.testing.assert_allclose(got.loc["correlation", label],
                                   want.loc["correlation", label],
                                   rtol=_rtol(label), err_msg=label)
        _assert_log_p([got.loc["p-value", label]],
                      [want.loc["p-value", label]], label)


def test_run_correlation_without_runs_has_the_filters_only(cat):
    """A method with no run, or no model directory, is skipped."""
    res, agg = run_correlation(cat, model_dir=None, device="cpu")
    assert agg.columns == ["", "1", "AVG9", "AVG", "KB"]
    res, _ = run_correlation(cat, model_dir=PORT_MODELS,
                             filter_names=("KB",), unet_methods=("LSBR",
                                                                 "nope"),
                             device="cpu")
    assert frame(res)["model_name"].unique().tolist() == [
        "KB", "UNet_LSBR_l1ws"]


def test_subset_residual_draws_jax_indices():
    rng = np.random.default_rng(1)
    resid = rng.standard_normal((126, 126)).astype(np.float32)
    for name in ("images/6_00.png", "images/x.png"):
        np.testing.assert_array_equal(
            error_boxes.subset_residual(resid, name, 1000),
            jax_boxes.subset_residual(resid, name, 1000))
    np.testing.assert_array_equal(error_boxes.subset_residual(resid, "a"),
                                  resid.flatten())


def _populations(seed, n=6000, kb_max=40):
    rng = np.random.default_rng(seed)
    kb = rng.integers(0, kb_max, n) / 4.0          # many ties
    return {"KB": kb.astype(np.float32),
            "AVG": (kb + rng.normal(0, 1, n)).astype(np.float32),
            "UNet_l1": np.abs(rng.normal(0, 3, n)).astype(np.float32)}


@pytest.mark.parametrize("seed, kb_max", [(0, 40), (1, 12), (2, 2)])
def test_box_stats_equal_jax_bucket_quantiles_bit_for_bit(seed, kb_max):
    """On the same populations, ties in the anchor and empty buckets
    included (kb_max 12 leaves the top bucket empty, 2 all but one)."""
    pops = _populations(seed, kb_max=kb_max)
    want = jax_boxes.bucket_quantiles(dict(pops), anchor="KB")
    got = frame(bucket_quantiles(dict(pops), anchor="KB"))
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True),
                                  check_exact=True)


def test_box_stats_on_jax_populations_bit_for_bit(jax_runs):
    pops = jax_runs["populations"]
    got = frame(bucket_quantiles(pops, anchor="KB"))
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True),
        jax_runs["boxes"].reset_index(drop=True), check_exact=True)


def _assert_boxes_match(got: pd.DataFrame, want: pd.DataFrame):
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert got["Type"].tolist() == want["Type"].tolist()
    assert got["edge_interval"].tolist() == want["edge_interval"].tolist()
    for i, label in enumerate(want["Type"]):
        atol = UNET_DIFF_ATOL if label.startswith("UNet") else 0
        np.testing.assert_allclose(
            got.iloc[i, 2:].to_numpy(float), want.iloc[i, 2:].to_numpy(float),
            rtol=_rtol(label), atol=atol,
            err_msg=f"{label} {want['edge_interval'][i]}")


def test_run_error_boxes_matches_jax(cat, jax_runs):
    pops = error_boxes.residual_populations(
        cat, list(pd.read_csv(cat / "split_te.csv")["name"]),
        device="cpu")
    for label in ("KB", "AVG"):
        assert pops[label].shape == jax_runs["populations"][label].shape
    got = run_error_boxes(cat, model_dir=PORT_MODELS, batch_size=3,
                          device="cpu")
    assert set(got["Type"]) == {"KB", "AVG", "UNet_l1", "UNet_l1ws"}
    _assert_boxes_match(frame(got), jax_runs["boxes"])


def test_cli_ae_boxes_csv_matches_jax(cat, jax_runs, tmp_path):
    assert torch_main(["error-boxes", "--data", str(cat), "--results",
                       str(tmp_path), "--model-dir", str(PORT_MODELS),
                       "--device", "cpu", "--fast-conv"]) == 0
    rel = "prediction/ae_boxes_3.csv"
    got = pd.read_csv(tmp_path / rel)
    want = pd.read_csv(jax_runs["dir"] / rel)
    assert list(got.columns) == ["Type", "edge_interval", "min", "q_25_iqr",
                                 "q_25", "q_50", "q_75", "q_75_iqr", "max"]
    _assert_boxes_match(got, want)
    assert (tmp_path / "prediction/ae_boxes_3.png").stat().st_size > 0


def test_difference_image_matches_jax(cat, tmp_path):
    fname = cat / "images" / _first_cover(cat)
    kb = difference_image(fname, "KB", device="cpu")
    want = np.asarray(jax_contour.difference_image(fname, "KB"))
    assert kb.shape == (126, 126) and kb.dtype == np.float32
    np.testing.assert_allclose(kb, want, rtol=0, atol=KB_DIFF_ATOL)
    for fast_conv in (False, True):
        unet = difference_image(fname, "UNet", PORT_MODELS, "LSBR",
                                fast_conv=fast_conv, device="cpu")
        np.testing.assert_allclose(
            unet, jax_contour.difference_image(fname, "UNet", JAX_MODELS,
                                               "LSBR"),
            rtol=0, atol=UNET_DIFF_ATOL)
    png = plot_contour(fname, kb, "KB", tmp_path)
    assert png.name == f"contour_KB_{fname.stem}.png"
    assert png.stat().st_size > 0


def test_cli_contour_writes_jax_files(cat, jax_runs, tmp_path):
    image = "images/" + _first_cover(cat)
    assert torch_main(["contour", "--data", str(cat), "--results",
                       str(tmp_path), "--model-dir", str(PORT_MODELS),
                       "--image", image, "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "prediction").iterdir())
    assert names == sorted(
        p.name for p in (jax_runs["dir"] / "prediction").glob("contour_*"))
    assert len(names) == 2
    with pytest.raises(SystemExit, match="does not support --split"):
        torch_main(["contour", "--data", str(cat), "--take", "2",
                    "--device", "cpu"])


def test_analyses_device_rule(cat):
    """Without a card and without device="cpu" the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fname = cat / "images" / _first_cover(cat)
    with pytest.raises(UserError, match="device='cpu'"):
        difference_image(fname, "KB")
    with pytest.raises(UserError, match="device='cpu'"):
        run_correlation(cat)
    with pytest.raises(SystemExit, match="^error-boxes: CUDA is not"):
        torch_main(["error-boxes", "--data", str(cat)])


# the CLI with JAX's per-pair rows and populations in place of its own
_ON_JAX_NUMBERS = LOAD_TABLE + """
import sys
import numpy as np
from wsunet_tpu_torch.analyses import correlation, error_boxes
from wsunet_tpu_torch.cli import main
rows = load_table(sys.argv[1])
correlation.correlation_rows = lambda *a, **k: [
    dict(zip(rows.columns, r)) for r in zip(*(rows[c] for c in rows.columns))]
z = np.load(sys.argv[2], allow_pickle=True)
pops = {str(k): z[f"p{i}"] for i, k in enumerate(z["labels"])}
error_boxes.residual_populations = lambda *a, **k: dict(pops)
for cmd in ("correlation", "error-boxes"):
    assert main([cmd, *sys.argv[3:]]) == 0
"""


@pytest.fixture(scope="module")
def blocked_outputs(cat, jax_runs, tmp_path_factory):
    """The port's ``correlation``, ``error-boxes`` (both ``--fast-conv``)
    and ``contour`` in processes without the five host packages, on its
    own numbers (``own``) and, for the first two, on JAX's per-pair rows
    and populations (``jax_numbers``); the stderr of each."""
    tmp = tmp_path_factory.mktemp("blocked")
    base = ["--data", cat, "--model-dir", PORT_MODELS, "--device", "cpu"]
    own = tmp / "own"
    errs = {cmd: run_without_host_packages(
        [cmd, *base, "--results", own, *extra], tmp).stderr
        for cmd, extra in (
            ("correlation", ["--fast-conv"]),
            ("error-boxes", ["--fast-conv"]),
            ("contour", ["--fast-conv", "--image",
                         "images/" + _first_cover(cat)]))}
    save_columns(jax_runs["rows"], tmp / "rows.npz")
    pops = jax_runs["populations"]
    np.savez(tmp / "pops.npz", labels=np.array(list(pops), dtype=object),
             **{f"p{i}": v for i, v in enumerate(pops.values())})
    run_without_host_packages(
        [tmp / "rows.npz", tmp / "pops.npz", *base, "--results",
         tmp / "jax_numbers"], tmp, code=_ON_JAX_NUMBERS)
    return {"own": own, "jax_numbers": tmp / "jax_numbers", "errs": errs}


@pytest.mark.parametrize("rel", ["estimation/correlation.csv",
                                 "prediction/ae_boxes_3.csv"])
def test_cli_csv_without_host_packages_is_jax_bytes_on_jax_numbers(
        jax_runs, blocked_outputs, rel):
    """``correlation`` and ``error-boxes`` where pandas, PIL, cv2,
    matplotlib and seaborn cannot be imported, on the per-pair rows and
    populations of the JAX CLI's run: its files, byte for byte."""
    got = (blocked_outputs["jax_numbers"] / rel).read_bytes()
    assert got == (jax_runs["dir"] / rel).read_bytes()
    assert got.startswith(b",1,AVG9,AVG,KB,UNet_dropout_l1," if
                          rel.startswith("estimation") else b"Type,")


def test_cli_without_host_packages_on_its_own_numbers(cat, jax_runs,
                                                      blocked_outputs):
    """On the port's own numbers (B1's plain version here): the header
    line and the row labels are JAX's bytes, the numbers within the
    bounds above; each figure not drawn is named on stderr, and none is
    written."""
    own, errs = blocked_outputs["own"], blocked_outputs["errs"]
    for rel, labels in (("estimation/correlation.csv", 1),
                        ("prediction/ae_boxes_3.csv", 2)):
        got = (own / rel).read_text().splitlines()
        want = (jax_runs["dir"] / rel).read_text().splitlines()
        assert got[0] == want[0] and len(got) == len(want)
        assert [r.split(",")[:labels] for r in got] == \
            [r.split(",")[:labels] for r in want]
    got = pd.read_csv(own / "estimation/correlation.csv", index_col=0)
    want = pd.read_csv(jax_runs["dir"] / "estimation/correlation.csv",
                       index_col=0)
    for label in want.columns:
        np.testing.assert_allclose(got.loc["correlation", label],
                                   want.loc["correlation", label],
                                   rtol=_rtol(label), err_msg=label)
        _assert_log_p([got.loc["p-value", label]],
                      [want.loc["p-value", label]], label)
    _assert_boxes_match(pd.read_csv(own / "prediction/ae_boxes_3.csv"),
                        pd.read_csv(jax_runs["dir"] /
                                    "prediction/ae_boxes_3.csv"))
    assert "ae_boxes_3.png not drawn" in errs["error-boxes"]
    stem = _first_cover(cat)[:-len(".png")]
    for model in ("KB", "unet"):
        assert f"contour_{model}_{stem}.png not drawn" in errs["contour"]
    assert not list(own.rglob("*.png"))
