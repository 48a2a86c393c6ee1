"""Port parity: ``filters-eval`` (wsunet_tpu_torch.ws.filters_eval, the
``filters-eval`` subcommand, ops.filters' residuals and coefficients)
against the JAX package, on the CPU, small: an 8-cover catalog of
data_ablation/p128 (128x128), a 4-cover RGB fixture at 64x64, and the
golden file ``weights/golden/p128_filters.npz`` (JAX's MAE and wMAE on
the 64 p128 covers and the color4 case).

Tolerances: the CSVs to six decimals (f32 means of about 16,000
residuals summed in another order: one f32 ulp); per-image MAE and wMAE
against JAX rel 1e-6; the decile bitwise ``jnp.quantile``'s; residuals
and coefficients exact.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from torch_p128 import P128, REPO, make_catalog, run_without_host_packages
from wsunet_tpu.ops import filters as jfilters
from wsunet_tpu.ws import filters_eval as jfe
from wsunet_tpu_torch.ops import filters as tfilters
from wsunet_tpu_torch.utils.errors import UserError
from wsunet_tpu_torch.ws import filters_eval as tfe

GOLDEN = REPO / "weights" / "golden" / "p128_filters.npz"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on the machine's cores, and with a thread per core in every
    worker the many small ops of these steps slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return make_catalog(tmp_path_factory.mktemp("fe") / "data", n=8,
                        alphas=(0.1,))


def _cli_csvs(data, tmp_path, *args):
    from wsunet_tpu.cli import main as jax_main
    from wsunet_tpu_torch.cli import main as torch_main

    jax_main(["filters-eval", "--data", str(data), "--results",
              str(tmp_path / "jax"), *args])
    assert torch_main(["filters-eval", "--data", str(data), "--results",
                       str(tmp_path / "torch"), "--device", "cpu",
                       *args]) == 0
    return [pd.read_csv(tmp_path / side / "prediction" / "filters.csv")
            for side in ("jax", "torch")]


def _same_csv(want, got):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    num = [c for c in want.columns if c.startswith(("mae_", "wmae_"))]
    np.testing.assert_almost_equal(got[num].to_numpy(),
                                   want[num].to_numpy(), decimal=6)
    rest = [c for c in want.columns if c not in num]
    pd.testing.assert_frame_equal(got[rest], want[rest])


@pytest.mark.parametrize("inbayer", [None, "00", "01", "10", "11"])
def test_filters_eval_csv_is_the_jax_clis(cat, tmp_path, inbayer):
    """``filters-eval --device cpu`` (KB and AVG on the luminance plane)
    writes the JAX CLI's prediction/filters.csv: columns, row order,
    catalog columns and the values to six decimals."""
    extra = ["--inbayer", inbayer] if inbayer else []
    want, got = _cli_csvs(cat, tmp_path, "--filters", "KB", "AVG", *extra)
    _same_csv(want, got)
    assert got["mae_3_KB"].notna().sum() == 8
    assert got["fname"].iloc[0] == str(cat / "images" / "6_00.png")


def test_filters_eval_without_host_packages_is_the_jax_clis(cat, tmp_path):
    """``filters-eval`` in a fresh interpreter where pandas, PIL, cv2 and
    matplotlib cannot be imported writes the JAX CLI's file."""
    from wsunet_tpu.cli import main as jax_main

    jax_main(["filters-eval", "--data", str(cat), "--results",
              str(tmp_path / "jax"), "--filters", "KB", "AVG"])
    run_without_host_packages(["filters-eval", "--data", cat, "--results",
                               tmp_path / "torch", "--device", "cpu",
                               "--filters", "KB", "AVG"], tmp_path)
    want, got = [pd.read_csv(tmp_path / side / "prediction" / "filters.csv")
                 for side in ("jax", "torch")]
    _same_csv(want, got)
    assert got["mae_3_KB"].notna().sum() == 8


@pytest.fixture(scope="module")
def color_root(tmp_path_factory):
    """4 smooth RGB covers at 64x64 (the JAX package's colour fixture)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("colour")
    (root / "images").mkdir()
    rng = np.random.default_rng(7)
    for i in range(4):
        base = rng.normal(0, 40, (68, 68, 3)).cumsum(0).cumsum(1)
        base = base / np.abs(base).max() * 90 + 120
        img = np.clip(base + rng.normal(0, 2, base.shape), 0, 255)
        Image.fromarray(img[2:66, 2:66].astype("uint8"), "RGB").save(
            root / "images" / f"{i}.png")
    pd.DataFrame([{"name": f"images/{i}.png", "height": 64, "width": 64}
                  for i in range(4)]).to_csv(root / "images" / "files.csv",
                                             index=False)
    return root


@pytest.mark.parametrize("inbayer", [None, "01"])
def test_filters_eval_colour_channels_are_the_jax_clis(color_root, tmp_path,
                                                       inbayer):
    extra = ["--inbayer", inbayer] if inbayer else []
    want, got = _cli_csvs(color_root, tmp_path, "--filters", "KB", "AVG",
                          "KB", "--channels", "0", "1", "2", *extra)
    _same_csv(want, got)
    assert {"mae_0_KB", "wmae_1_AVG", "mae_2_KB"} <= set(got.columns)


def test_golden_filters_hold_on_the_cpu():
    """JAX's per-image MAE and wMAE on the 64 p128 covers (every
    ``inbayer``) and on the color4 case (channels 0-2), from the golden
    file, against the port's step on the same pixels."""
    z = np.load(GOLDEN)
    covers = np.load(REPO / "weights" / "golden" / "p128_lsbr.npz")[
        "pixels"][0]
    color = np.load(REPO / "weights" / "golden" / "p128_b0.npz")[
        "color/pixels"]
    assert list(z["names"]) == list(np.load(
        REPO / "weights" / "golden" / "p128_lsbr.npz")["names"])
    for f in z["filters"]:
        kernel = tfilters.taps_to_kernel2d(tfilters.NAMED_FILTERS[str(f)])
        for b in z["inbayer"]:
            b = str(b)
            got = [tfe.mae_wmae(torch.from_numpy(covers[i:i + 8]), kernel,
                                inbayer=None if b == "none" else b)
                   for i in range(0, 64, 8)]
            for j, key in enumerate(("mae", "wmae")):
                np.testing.assert_allclose(
                    torch.cat([g[j] for g in got]).numpy(),
                    z[f"{key}/{f}/{b}"], rtol=1e-6, err_msg=f"{key} {f} {b}")
        for c in range(3):
            got = [tfe.mae_wmae(torch.from_numpy(p), kernel, channel=c)
                   for p in color]
            for j, key in enumerate(("mae", "wmae")):
                np.testing.assert_allclose(
                    np.stack([g[j].numpy() for g in got]),
                    z[f"color/{key}/{f}/{c}"], rtol=1e-6)


@pytest.mark.parametrize("n, ties", [(1000, False), (16129, False),
                                     (130, True), (11, True), (1, False)])
def test_decile_is_jnp_quantile_bitwise(n, ties):
    """``quantile_linear`` against ``jnp.quantile`` (f32, linear): bitwise
    on random rows, with ties (a HILL map clamps its wet pixels to 1e10)
    and with the decile's position on and between order statistics."""
    rng = np.random.default_rng(n)
    v = rng.gamma(2.0, 3.0, (4, n)).astype(np.float32)
    if ties:
        v = np.round(v).astype(np.float32)
        v[:, ::3] = 1e10
    for q in (0.1, 0.5, 0.0, 1.0):
        want = np.asarray(jnp.quantile(jnp.asarray(v), q, axis=1))
        got = tfe.quantile_linear(torch.from_numpy(v), q).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_allclose(got, np.quantile(v, q, axis=1),
                                   rtol=1e-6)


@pytest.mark.parametrize("inbayer", [None, "00", "01", "10", "11"])
def test_bayer_slices_and_residuals_are_jax(inbayer):
    assert tfe.bayer_slices(inbayer) == jfe.bayer_slices(inbayer)
    x = np.random.default_rng(1).integers(0, 256, (2, 13, 11)).astype(
        np.float32)
    for name in ("KB", "AVG", "AVG9", "1"):
        k2 = tfilters.get_coefficients(name, flatten=False)
        np.testing.assert_array_equal(
            k2, jfilters.get_coefficients(name, flatten=False))
        np.testing.assert_array_equal(
            tfilters.get_coefficients(name),
            jfilters.get_coefficients(name))
        want = np.asarray(jfilters.filter_residuals(jnp.asarray(x), k2))
        got = tfilters.filter_residuals(torch.from_numpy(x), k2).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        s1, s2 = tfe.bayer_slices(inbayer)
        assert got[:, s1, s2].shape == want[:, s1, s2].shape


def test_sweep_gives_nan_for_a_corrupt_file_and_run_drops_it(cat, tmp_path):
    """A file that fails to decode is a NaN row of ``filters_sweep`` and
    no row of ``run``, as the JAX sweep skips its masked rows; the others
    keep their values."""
    import shutil

    data = tmp_path / "data"
    shutil.copytree(cat, data)
    bad = data / "images" / "6_02.png"
    bad.write_bytes(b"not a png")
    names = [f"images/{p.name}" for p in sorted((cat / "images").glob(
        "*.png"))]
    good = tfe.filters_sweep(cat, names, "KB", batch_size=3, device="cpu")
    got = tfe.filters_sweep(data, names, "KB", batch_size=3, device="cpu")
    i = names.index("images/6_02.png")
    assert np.isnan(got[i]).all() and np.isfinite(np.delete(got, i, 0)).all()
    np.testing.assert_array_equal(np.delete(got, i, 0), np.delete(good, i, 0))
    df = tfe.run(data, filter_names=["KB"], channels=[(3,)], batch_size=3,
                 device="cpu")
    assert len(df) == 7 and "images/6_02.png" not in set(df["name"])


def test_filters_eval_refuses_without_a_card():
    from wsunet_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UserError, match="CUDA is not available"):
        tfe.run(P128)
    with pytest.raises(SystemExit, match="^filters-eval: CUDA is not"):
        main(["filters-eval", "--data", str(P128)])
