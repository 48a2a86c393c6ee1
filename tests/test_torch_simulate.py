"""Port parity: the simulators, the seeding helpers and the trainer's
augmentation cores (wsunet_tpu_torch.data.simulate, .data.transforms,
.utils.seeding) against the JAX package, on the CPU.

Tolerances: bitwise throughout.  HILLr is deterministic and its output
is held bitwise to JAX's (both take the same cost map up to f32 rounding
in another order; on these covers no pixel near the cut moves).  LSBr's
draws are torch's, so its stego differs from JAX's image by image: the
pure core ``lsbr_embed`` is held bitwise on JAX's own draws, and the
wrapper by its change rate (alpha / 2 within five binomial standard
deviations) and direction (x ^ 1 on changed pixels).
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_p128 import P128
from wsunet_tpu.data import load_images as jax_load_images
from wsunet_tpu.data import simulate as jsim
from wsunet_tpu.data import transforms as jtr
from wsunet_tpu.utils import seeding as jseed
from wsunet_tpu_torch.data import simulate as tsim
from wsunet_tpu_torch.data import transforms as ttr
from wsunet_tpu_torch.utils import seeding as tseed

NAMES = sorted(p.name for p in (P128 / "images").glob("*.png"))


@pytest.fixture(scope="module")
def covers():
    return jax_load_images(P128, [f"images/{n}" for n in NAMES[:16]])


@pytest.mark.parametrize("name", ["images/6_00.png", "6_00", "a/b/c.PNG",
                                  "stego_LSBr_alpha_0.1_x/7_13.png", ""])
def test_filename_to_image_seed_is_jax(name):
    assert tseed.filename_to_image_seed(name) == \
        jseed.filename_to_image_seed(name)


def test_seed_everything_returns_a_seeded_generator():
    g = tseed.seed_everything(7)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7
    a = np.random.random()
    tseed.seed_everything(7)
    assert np.random.random() == a


@pytest.mark.parametrize("alpha", [0.01, 0.4, 1.0])
def test_lsbr_embed_on_jax_draws_is_bitwise(covers, alpha):
    """JAX's lsbr_simulate, replayed: its key splits give the mask and the
    bits, and the port's pure core on them gives JAX's stego."""
    x = covers[:4]
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsim.lsbr_simulate(jnp.asarray(x), alpha, key))
    k1, k2 = jax.random.split(key)
    embed = np.asarray(jax.random.uniform(k1, x.shape) < alpha)
    bits = np.asarray(jax.random.bernoulli(k2, 0.5, x.shape))
    got = tsim.lsbr_embed(torch.from_numpy(x), torch.from_numpy(embed),
                          torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", [0.1, 0.4, 1.0])
def test_lsbr_simulate_change_rate_and_direction(covers, alpha):
    x = torch.from_numpy(covers)
    g = torch.Generator().manual_seed(3)
    y = tsim.lsbr_simulate(x, alpha, g)
    changed = (y != x).numpy()
    n = changed.size
    p = alpha / 2
    assert abs(changed.mean() - p) <= 5 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_array_equal(y.numpy()[changed],
                                  (x.numpy() ^ 1)[changed])
    # the same generator state gives the same stego
    again = tsim.lsbr_simulate(x, alpha, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)


def test_lsbr_simulate_takes_per_image_alphas(covers):
    x = torch.from_numpy(covers[:4])
    alphas = torch.tensor([0.0, 1.0, 0.0, 0.4])
    y = tsim.lsbr_simulate(x, alphas, torch.Generator().manual_seed(0))
    rates = (y != x).float().mean(dim=(1, 2)).numpy()
    assert rates[0] == 0 and rates[2] == 0
    assert abs(rates[1] - 0.5) < 0.03 and abs(rates[3] - 0.2) < 0.03


@pytest.mark.parametrize("alpha", [1.0, 0.4, 0.1, 0.01])
def test_hillr_is_jax_bitwise_on_p128(alpha):
    x = jax_load_images(P128, [f"images/{n}" for n in NAMES])
    want = np.asarray(jsim.hillr_simulate(jnp.asarray(x), alpha))
    got = tsim.hillr_simulate(torch.from_numpy(x), alpha).numpy()
    np.testing.assert_array_equal(got, want)
    n = int(round(alpha / 2 * 128 * 128))
    assert ((got != x).sum(axis=(1, 2)) == n).all()


def _tied_covers():
    """Covers whose HILL costs tie: a repeated 8x8 tile (every tile has
    the same costs away from the border), a flat image (every cost wet),
    half flat and half noise, and a noise image."""
    rng = np.random.default_rng(5)
    tile = rng.integers(40, 200, (8, 8))
    half = np.full((64, 64), 128)
    half[:, 32:] = rng.integers(0, 256, (64, 32))
    return np.stack([np.tile(tile, (8, 8)), np.full((64, 64), 77), half,
                     rng.integers(0, 256, (64, 64))]).astype(np.uint8)


@pytest.mark.parametrize("alpha", [0.02, 0.1, 0.4, 1.0])
def test_hillr_breaks_ties_as_jax(alpha):
    x = _tied_covers()
    want = np.asarray(jsim.hillr_simulate(jnp.asarray(x), alpha))
    got = tsim.hillr_simulate(torch.from_numpy(x), alpha).numpy()
    np.testing.assert_array_equal(got, want)
    n = int(round(alpha / 2 * 64 * 64))
    assert ((got != x).sum(axis=(1, 2)) == n).all()


def test_hillr_flips_on_a_given_cost_map():
    """The pure selection on a cost map with many ties at the threshold:
    the cheaper pixels all flip, the tied ones in row-major order."""
    rho = torch.tensor([[[3., 1., 2., 2.], [2., 0., 2., 5.]]])
    got = tsim.hillr_flips(rho, 4)
    want = torch.tensor([[[False, True, True, True],
                          [False, True, False, False]]])
    assert torch.equal(got, want)
    assert not tsim.hillr_flips(rho, 0).any()
    assert tsim.hillr_flips(rho, 8).all()


def test_hillr_with_no_change_returns_the_cover():
    x = torch.from_numpy(_tied_covers())
    assert torch.equal(tsim.hillr_simulate(x, 1e-6), x)


def test_simulate_dispatch_and_image_key():
    x = torch.from_numpy(_tied_covers())
    g = tsim.image_key("images/6_00.png", salt=2)
    assert g.initial_seed() == jseed.filename_to_image_seed("6_00") + 2
    a = tsim.simulate(x, "LSBr", 0.4, tsim.image_key("a.png"))
    b = tsim.simulate(x, "lsbr", 0.4, tsim.image_key("a.png"))
    assert torch.equal(a, b) and not torch.equal(a, x)
    assert torch.equal(tsim.simulate(x, "HILLR", 0.4),
                       tsim.hillr_simulate(x, 0.4))
    with pytest.raises(ValueError, match="generator"):
        tsim.simulate(x, "LSBR", 0.4)
    with pytest.raises(NotImplementedError):
        tsim.simulate(x, "WOW", 0.4)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rot90_is_jnp_rot90_on_hwc(k):
    """torch.rot90(x, k, dims=(2, 3)) on NCHW is jnp.rot90(v, k,
    axes=(0, 1)) on the HWC image, for every k (checked, not assumed)."""
    v = np.random.default_rng(k).random((6, 6, 2)).astype(np.float32)
    want = np.asarray(jnp.rot90(jnp.asarray(v), k, axes=(0, 1)))
    nchw = torch.from_numpy(v.transpose(2, 0, 1))[None]
    got = torch.rot90(nchw, k, dims=(2, 3))[0].numpy().transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)
    got = ttr.rot90(nchw, torch.tensor([k]))[0].numpy().transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flip_and_rot90_cores_on_jax_draws_are_bitwise(covers, seed):
    """JAX's random_flip / random_rot90 on an NHWC batch, and the port's
    cores on the same draws (replayed from JAX's key splits) on the
    channel-free batch and on NCHW."""
    x = covers[:8, :32, :32]
    key = jax.random.PRNGKey(seed)
    kf, kr = jax.random.split(key)
    xj = jnp.asarray(x)[..., None]
    want = np.asarray(jtr.random_rot90(jtr.random_flip(xj, kf), kr))[..., 0]
    kh, kv = jax.random.split(kf)
    fh = np.asarray(jax.random.bernoulli(kh, shape=(8, 1, 1, 1))).reshape(8)
    fv = np.asarray(jax.random.bernoulli(kv, shape=(8, 1, 1, 1))).reshape(8)
    k = np.asarray(jax.random.randint(kr, (8,), 0, 4))
    draws = (torch.from_numpy(fh), torch.from_numpy(fv))
    got = ttr.rot90(ttr.flip(torch.from_numpy(x), *draws),
                    torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)
    got4 = ttr.rot90(ttr.flip(torch.from_numpy(x)[:, None], *draws),
                     torch.from_numpy(k))
    np.testing.assert_array_equal(got4[:, 0].numpy(), want)


def test_crop_is_jax_dynamic_slice(covers):
    x = covers[:4]
    oi, oj = np.array([0, 64, 17, 3]), np.array([64, 0, 5, 40])
    want = np.stack([np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(img), (int(i), int(j)), (64, 64)))
        for img, i, j in zip(x, oi, oj)])
    got = ttr.crop(torch.from_numpy(x), torch.from_numpy(oi),
                   torch.from_numpy(oj), 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_wrappers_draw_from_the_generator(covers):
    x = torch.from_numpy(covers[:16, :16, :16])
    a = ttr.random_rot90(ttr.random_flip(x, torch.Generator().manual_seed(4)),
                         torch.Generator().manual_seed(5))
    b = ttr.random_rot90(ttr.random_flip(x, torch.Generator().manual_seed(4)),
                         torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    # each output image is one of the 8 symmetries of its input
    for img, out in zip(x, a):
        sym = [torch.rot90(f, r) for f in (img, img.flip(-1))
               for r in range(4)]
        assert any(torch.equal(out, s) for s in sym)


@pytest.fixture(scope="module")
def four_covers(tmp_path_factory):
    root = tmp_path_factory.mktemp("p128_4")
    (root / "images").mkdir()
    lines = ["name,height,width"]
    for name in NAMES[:4]:
        shutil.copyfile(P128 / "images" / name, root / "images" / name)
        lines.append(f"images/{name},128,128")
    (root / "images" / "files.csv").write_text("\n".join(lines) + "\n")
    return root


def _simulate_both(four_covers, tmp_path, method, alphas):
    from wsunet_tpu.cli import main as jax_main
    from wsunet_tpu_torch.cli import main as torch_main

    roots = {}
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        roots[side] = tmp_path / side
        shutil.copytree(four_covers, roots[side])
        extra = ["--device", "cpu"] if side == "torch" else []
        assert main(["simulate", "--data", str(roots[side]), "--method",
                     method, "--alphas", *map(str, alphas), *extra]) == 0
    return roots


def test_cli_simulate_hillr_writes_jax_files(four_covers, tmp_path):
    import pandas as pd

    roots = _simulate_both(four_covers, tmp_path, "HILLr", [0.1, 0.4])
    for alpha in (0.1, 0.4):
        sub = f"stego_HILLr_alpha_{alpha}_independent_images"
        a = pd.read_csv(roots["jax"] / sub / "files.csv")
        b = pd.read_csv(roots["torch"] / sub / "files.csv")
        pd.testing.assert_frame_equal(a, b)
        names = [n.split("/")[-1] for n in a["name"]]
        np.testing.assert_array_equal(
            jax_load_images(roots["jax"] / sub, names),
            jax_load_images(roots["torch"] / sub, names))


def test_cli_simulate_lsbr_schema_and_rate(four_covers, tmp_path):
    import pandas as pd

    roots = _simulate_both(four_covers, tmp_path, "LSBr", [0.4])
    sub = "stego_LSBr_alpha_0.4_independent_images"
    a = pd.read_csv(roots["jax"] / sub / "files.csv")
    b = pd.read_csv(roots["torch"] / sub / "files.csv")
    pd.testing.assert_frame_equal(a, b)
    assert list(b.columns) == ["name", "height", "width", "stego_method",
                               "alpha"]
    names = [n.split("/")[-1] for n in a["name"]]
    cov = jax_load_images(four_covers / "images", names)
    st = jax_load_images(roots["torch"] / sub, names)
    changed = st != cov
    assert abs(changed.mean() - 0.2) < 5 * np.sqrt(0.2 * 0.8 / cov.size)
    np.testing.assert_array_equal(st[changed], (cov ^ 1)[changed])
    # the port's draws are its own: per image, seeded by the file name
    g = tsim.image_key(a["name"][0])
    want = tsim.lsbr_simulate(torch.from_numpy(cov[:1]), 0.4, g)[0]
    np.testing.assert_array_equal(st[0], want.numpy())


@pytest.mark.parametrize("flag", [["--split", "split_tr.csv"],
                                  ["--take", "2"]])
def test_cli_simulate_refuses_a_row_selection(four_covers, flag):
    from wsunet_tpu_torch.cli import main as torch_main

    with pytest.raises(SystemExit, match="does not support --split/--take"):
        torch_main(["simulate", "--data", str(four_covers), "--device",
                    "cpu", *flag])


def test_simulate_without_a_card_raises(four_covers):
    from wsunet_tpu_torch.cli import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        torch_main(["simulate", "--data", str(four_covers)])
