"""Port parity: the HILL cost map and the selection-channel-aware WS score
(wsunet_tpu_torch.ops.hill_cost, ws_attack_sca) against the JAX package's,
on the CPU.

hill_cost: rtol 1e-5 on finite costs (f32 box sums in another order than
XLA's convolution), the same infinities.  The quantile: 1 f32 ulp.
ws_attack_sca: rtol 1e-4, atol
1e-5 (the quantile's position and weights are computed as jnp.quantile
computes them; a pixel whose cost lies within rounding of the threshold
could still fall on the other side of it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wsunet_tpu.ops import NAMED_FILTERS_2D
from wsunet_tpu.ops import hill_cost as jax_hill_cost
from wsunet_tpu.ops import ws_attack_sca as jax_sca
from wsunet_tpu_torch.data import load_images
from wsunet_tpu_torch.ops import hill_cost, ws_attack_sca
from wsunet_tpu_torch.ops.hill import _pad_symmetric
from wsunet_tpu_torch.ops.ws import _quantile_linear

from torch_p128 import P128

SCA_RTOL, SCA_ATOL = 1e-4, 1e-5


def _images(shape, seed, flat=False):
    x = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    if flat:   # a zero-texture block: infinite costs
        x[..., 4:20, 6:22] = 117
    return x


@pytest.mark.parametrize("shape, wet", [
    ((3, 40, 37), None), ((3, 40, 37), 1e10), ((2, 24, 30), 1e10),
    ((31, 29), None)])
def test_hill_cost_matches_jax(shape, wet):
    x = _images(shape, seed=sum(shape), flat=True)
    want = np.asarray(jax_hill_cost(jnp.asarray(x), wet_cost=wet))
    got = hill_cost(torch.from_numpy(x), wet_cost=wet).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    if wet is None:
        assert np.isinf(want).any()   # the flat block reached the map
    else:
        assert (got == wet).any() and np.isfinite(got).all()


@pytest.mark.parametrize("shape, p", [((2, 5, 4), 7), ((1, 9, 9), 1),
                                      ((1, 3, 20), 7), ((2, 16, 16), 7)])
def test_symmetric_pad_is_numpys(shape, p):
    x = _images(shape, seed=p)
    want = np.pad(x, ((0, 0), (p, p), (p, p)), mode="symmetric")
    np.testing.assert_array_equal(
        _pad_symmetric(torch.from_numpy(x), p, p).numpy(), want)


@pytest.mark.parametrize("n", [2, 19, 324, 16129, 100_003])
@pytest.mark.parametrize("frac", [0.05, 0.5, 0.0, 1.0])
def test_quantile_is_jax_quantile(n, frac):
    v = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    v[1, : n // 2] = 1.0   # ties
    want = np.asarray(jnp.quantile(jnp.asarray(v), frac, axis=1))
    got = _quantile_linear(torch.from_numpy(v), frac).numpy()
    # the same position, neighbours and weights; XLA may fuse the final
    # a*w_lo + b*w_hi into one FMA, one rounding fewer: 1 ulp
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


def test_sca_matches_jax_on_p128_stego():
    from wsunet_tpu.data.simulate import image_key, simulate

    names = sorted(p.name for p in (P128 / "images").glob("*.png"))[:16]
    covers = load_images(P128 / "images", names)
    stego = np.stack([np.asarray(simulate(
        jnp.asarray(c[None]), "LSBr", 0.1, image_key(f"images/{n}")))[0]
        for c, n in zip(covers, names)])
    got = {}
    for label, x in (("cover", covers), ("stego", stego)):
        want = np.asarray(jax_sca(jnp.asarray(x),
                                  pixel_kernel=NAMED_FILTERS_2D["KB"]))
        got[label] = ws_attack_sca(torch.from_numpy(x),
                                   pixel_kernel=NAMED_FILTERS_2D["KB"]).numpy()
        np.testing.assert_allclose(got[label], want, rtol=SCA_RTOL,
                                   atol=SCA_ATOL)
    # the score amplifies the change rate inside the low-cost region
    assert got["stego"].mean() > got["cover"].mean()


@pytest.mark.parametrize("model", ["KB", "AVG"])
def test_sca_matches_jax_with_flat_regions_and_estimator(model):
    x = _images((4, 36, 33), seed=5, flat=True)
    want = np.asarray(jax_sca(jnp.asarray(x),
                              pixel_kernel=NAMED_FILTERS_2D[model]))
    got = ws_attack_sca(torch.from_numpy(x),
                        pixel_kernel=NAMED_FILTERS_2D[model]).numpy()
    np.testing.assert_allclose(got, want, rtol=SCA_RTOL, atol=SCA_ATOL)
    est = np.asarray(jax_sca(jnp.asarray(x), pixel_estimator=lambda v: 0.5 *
                             v[:, 1:-1, 1:-1]))
    got = ws_attack_sca(torch.from_numpy(x), pixel_estimator=lambda v: 0.5 *
                        v[:, 1:-1, 1:-1]).numpy()
    np.testing.assert_allclose(got, est, rtol=SCA_RTOL, atol=SCA_ATOL)


def test_sca_keeps_ties_at_the_threshold():
    """A flat image has the wet cost everywhere: ``<=`` keeps every pixel,
    so the score is the plain WS mean over the interior."""
    x = np.full((1, 24, 24), 77, np.uint8)
    x_hat = np.full((1, 22, 22), 77.5, np.float32)
    rho = hill_cost(torch.from_numpy(x), wet_cost=1e10)
    assert bool((rho == 1e10).all())
    got = ws_attack_sca(torch.from_numpy(x),
                        pixel_estimator=lambda v: torch.from_numpy(x_hat))
    # 77 is odd: x - xbar = 1, x - x_hat = -0.5 at every pixel
    np.testing.assert_array_equal(got.numpy(), [-0.5])
    want = np.asarray(jax_sca(jnp.asarray(x),
                              pixel_estimator=lambda v: jnp.asarray(x_hat)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sca_flips_the_uint8_value_of_a_float_input():
    """x_bar is taken on the uint8 value (the f32 -> uint8 cast comes
    before the XOR), whatever the input's dtype."""
    x = _images((2, 20, 20), seed=9)
    a = ws_attack_sca(torch.from_numpy(x), pixel_kernel=NAMED_FILTERS_2D["KB"])
    b = ws_attack_sca(torch.from_numpy(x).float(),
                      pixel_kernel=NAMED_FILTERS_2D["KB"])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
