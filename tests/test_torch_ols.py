"""Port parity: the OLS pixel predictors (wsunet_tpu_torch.ops.ols) and
OLS / colour planes in the WS sweeps (``ws.ws_run``, ``ws-eval --models
OLS --channels ...``) against the JAX package's, on the CPU.

Tolerances, and why.  The port sums the normal equations in float64, in
which integer pixels make every sum exact: its taps equal a float64
least-squares oracle to rounding (rtol 1e-9) and do not depend on the
order of the images.  JAX sums them in f32 and solves in f64, so its taps
carry the f32 rounding of sums near 1e8-1e10, amplified by the
conditioning of X^T X: measured 2.8e-4 from the exact taps on the 64 p128
covers (gray), up to 1.3e-3 on the synthetic colour covers (color4,
color8).  Hence taps within 2e-3 (gray) and 1e-2 (colour) of JAX's.  The
predictions move by the tap difference times the pixel values (up to
about 0.1 grey level with 17 or 26 colour taps), so beta_hat is held
within 2e-4 of JAX's for the gray fit and 1e-3 for the colour fits
(measured: 2.9e-4 colour).  The prediction from the same taps is held at
rtol 1e-5 / atol 1e-3 grey levels (f32 sums in another order).
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from torch_p128 import P128, REPO, frame, make_catalog
from wsunet_tpu.cli import main as jax_main
from wsunet_tpu.ops import ols as jols
from wsunet_tpu.ws import ws_run as jax_ws_run
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.io import imread_gray_u8
from wsunet_tpu_torch.ops import ols
from wsunet_tpu_torch.ops.filters import _NEIGHBOR_OFFSETS
from wsunet_tpu_torch.ops.ws import ws_attack
from wsunet_tpu_torch.ws import ws_run

GRAY_TAPS_ATOL, COLOR_TAPS_ATOL = 2e-3, 1e-2
BETA_ATOL, COLOR_BETA_ATOL = 2e-4, 1e-3
GOLDEN = REPO / "weights" / "golden" / "p128_b0.npz"


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "scripts" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def covers():
    return np.stack([imread_gray_u8(p) for p in
                     sorted((P128 / "images").glob("*.png"))])


@pytest.fixture(scope="module")
def color():
    """[2, 8, 64, 64, 4] uint8: seeded RGB covers and their LSB
    replacement in R, planes [R, G, B, Y] (the golden file's case)."""
    return _exporter().color_sets()


def _ring(x):
    """The reference's N x 9 neighbourhood matrix of one plane, float64."""
    h, w = x.shape[0] - 2, x.shape[1] - 2
    cols = [x[i:i + h, j:j + w].ravel() for i, j in _NEIGHBOR_OFFSETS]
    return np.stack(cols + [x[1:-1, 1:-1].ravel()], axis=-1)


def _oracle(images, channels=None):
    """float64 least squares over the stacked design."""
    X, y = [], []
    for img in images.astype(np.float64):
        if channels is None:
            m = _ring(img)
            X.append(m[:, :8])
        else:
            m = _ring(img[..., channels[-1]])
            X.append(np.concatenate(
                [_ring(img[..., c]) for c in channels[:-1]] + [m[:, :8]],
                axis=-1))
        y.append(m[:, 8])
    return np.linalg.lstsq(np.concatenate(X), np.concatenate(y),
                           rcond=None)[0]


def test_fit_ols_gray_matches_oracle_and_jax(covers):
    got = ols.fit_ols(torch.from_numpy(covers))
    assert got.shape == (8, 1) and got.dtype == np.float64
    np.testing.assert_allclose(got.ravel(), _oracle(covers), rtol=1e-9)
    want = jols.fit_ols(covers.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAY_TAPS_ATOL)
    np.testing.assert_array_equal(
        ols.ols_kernel2d(covers), ols.taps_to_kernel2d(got))


def test_normal_equations_are_exact(covers):
    """The same taps, bit for bit, whatever the order of the images and
    the size of the chunks they are summed in."""
    x = torch.from_numpy(covers)
    want = ols._solve(x)
    np.testing.assert_array_equal(ols._solve(x.flip(0), chunk=5), want)
    np.testing.assert_array_equal(ols._solve(x.float(), chunk=64), want)


@pytest.mark.parametrize("channels", [(1, 0), (2, 1, 0)])
def test_fit_ols_color_matches_oracle_and_jax(color, channels):
    covers4 = color[0]
    got = ols.fit_ols_color(torch.from_numpy(covers4).permute(0, 3, 1, 2),
                            channels)
    assert got.shape == (9 * (len(channels) - 1) + 8,)
    np.testing.assert_allclose(got, _oracle(covers4, channels), rtol=1e-9)
    want = jols.fit_ols_color(covers4.astype(np.float32), channels)
    np.testing.assert_allclose(got, want, rtol=0, atol=COLOR_TAPS_ATOL)
    with pytest.raises(ValueError, match="2 \\(color4\\) or 3"):
        ols.fit_ols_color(torch.from_numpy(covers4).permute(0, 3, 1, 2),
                          (0,))


@pytest.mark.parametrize("channels", [(1, 0), (2, 1, 0)])
def test_ols_color_predict_matches_jax(color, channels):
    """The same kernels through both predictors."""
    x4 = color[1].astype(np.float32)
    kernels = ols.ols_color_kernels(
        torch.from_numpy(color[0]).permute(0, 3, 1, 2), channels)
    assert list(kernels) == list(channels)
    want = np.asarray(jols.ols_color_predict(jnp.asarray(x4), kernels))
    got = ols.ols_color_predict(
        torch.from_numpy(x4).permute(0, 3, 1, 2), kernels).numpy()
    assert got.shape == (8, 62, 62)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_ols_matches_golden():
    """The golden file's JAX numbers: gray taps on the 64 p128 covers and
    OLS beta_hat on the covers and their stego; the color4 case."""
    with np.load(GOLDEN) as g, \
            np.load(REPO / "weights" / "golden" / "p128_lsbr.npz") as g0:
        gold = {k: g[k] for k in g.files}
        pixels = torch.from_numpy(g0["pixels"])
    taps = ols.fit_ols(pixels[0])
    np.testing.assert_allclose(taps, gold["ols/taps"], rtol=0,
                               atol=GRAY_TAPS_ATOL)
    kernel = ols.ols_kernel2d(pixels[0])[::-1, ::-1]
    beta = torch.stack([ws_attack(p, pixel_kernel=kernel) for p in pixels])
    np.testing.assert_allclose(beta.numpy(), gold["beta/OLS"], rtol=0,
                               atol=BETA_ATOL)
    channels = tuple(gold["color/channels"])
    x4 = torch.from_numpy(gold["color/pixels"]).permute(0, 1, 4, 2, 3)
    np.testing.assert_allclose(ols.fit_ols_color(x4[0], channels),
                               gold["color/taps"], rtol=0,
                               atol=COLOR_TAPS_ATOL)
    kernels = ols.ols_color_kernels(x4[0], channels)
    beta = torch.stack([ws_attack(
        x[:, channels[-1]],
        pixel_estimator=lambda _, x=x: ols.ols_color_predict(x.float(),
                                                             kernels))
        for x in x4])
    np.testing.assert_allclose(beta.numpy(), gold["color/beta"], rtol=0,
                               atol=COLOR_BETA_ATOL)
    assert (beta[1] > beta[0] + 0.05).all()    # it sees the embedding


@pytest.fixture(scope="module")
def gray_cat(tmp_path_factory):
    return make_catalog(tmp_path_factory.mktemp("p128"), n=12,
                        alphas=(0.1,))


@pytest.fixture(scope="module")
def color_cat(tmp_path_factory, color):
    """A colour catalog: the 8 covers as RGB PNGs and their stego (LSB
    replacement in R) as LSBR at alpha 0.4."""
    root = tmp_path_factory.mktemp("color")
    for sub, imgs, method, alpha in (
            ("images", color[0], "", ""),
            ("stego_LSBR_alpha_0.4_independent_images", color[1], "LSBR",
             0.4)):
        (root / sub).mkdir()
        rows = []
        for i, img in enumerate(imgs):
            Image.fromarray(img[..., :3], "RGB").save(root / sub / f"{i}.png")
            rows.append({"name": f"{sub}/{i}.png", "height": 64,
                         "width": 64, "stego_method": method,
                         "alpha": alpha})
        pd.DataFrame(rows).to_csv(root / sub / "files.csv", index=False)
    return root


def _assert_frames_match(got, want, beta_atol=BETA_ATOL):
    got = frame(got)
    assert list(got.columns) == list(want.columns)
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    assert len(got) == len(want) > 0
    for col in got.columns:
        if col == "beta_hat":
            np.testing.assert_allclose(got[col], want[col], rtol=0,
                                       atol=beta_atol)
        else:
            assert got[col].astype(str).tolist() == \
                want[col].astype(str).tolist(), col


@pytest.mark.parametrize("model, channels, catalog", [
    ("OLS", (3,), "gray"), ("OLS", (0,), "color"), ("OLS", (1, 0), "color"),
    ("OLS", (2, 1, 0), "color"), ("KB", (1,), "color"),
    ("KB-w", (0,), "color"), ("KB", (3,), "color")])
@pytest.mark.parametrize("stego", [False, True])
def test_ws_run_matches_jax(gray_cat, color_cat, model, channels, catalog,
                            stego):
    root = gray_cat if catalog == "gray" else color_cat
    alpha = (0.1 if catalog == "gray" else 0.4) if stego else None
    kw = dict(input_dir=root, stego_method="LSBR" if stego else None,
              alpha=alpha, model_name=model, channels=channels,
              batch_size=3)
    got = ws_run(device="cpu", **kw)
    _assert_frames_match(got, jax_ws_run(**kw), COLOR_BETA_ATOL
                         if len(channels) > 1 else BETA_ATOL)
    if model == "OLS" and len(channels) > 1:
        # the colour predictor sees the embedding in R; the covers stay low
        assert (got["beta_hat"].mean() > 0.1) == stego


def test_ols_fit_split_restricts_the_fit(gray_cat, tmp_path):
    """``ols_fit_split`` fits on the split's covers only, as in JAX."""
    covers = pd.read_csv(gray_cat / "images" / "files.csv")
    covers.iloc[:4].to_csv(gray_cat / "fit4.csv", index=False)
    kw = dict(input_dir=gray_cat, stego_method="LSBR", alpha=0.1,
              model_name="OLS", batch_size=8)
    got = ws_run(ols_fit_split="fit4.csv", device="cpu", **kw)
    _assert_frames_match(got, jax_ws_run(ols_fit_split="fit4.csv", **kw))
    assert not np.allclose(got["beta_hat"],
                           ws_run(device="cpu", **kw)["beta_hat"])


def test_cli_ws_eval_ols_and_channels_match_jax(color_cat,
                                                tmp_path_factory):
    out = {}
    for pkg, main in (("jax", jax_main), ("torch", torch_main)):
        res = tmp_path_factory.mktemp(pkg)
        dev = ["--device", "cpu"] if pkg == "torch" else []
        assert main(["ws-eval", "--data", str(color_cat), "--results",
                     str(res), *dev, "--models", "OLS", "KB", "--channels",
                     "1", "0", "--alphas", "0.4"]) == 0
        out[pkg] = pd.read_csv(res / "estimation" / "ws_sweep_LSBR.csv")
    _assert_frames_match(out["torch"], out["jax"], COLOR_BETA_ATOL)
    assert sorted(out["torch"]["model_name"].unique()) == ["KB", "OLS"]
    assert (out["torch"]["channels"] == 10).all()
