"""Port parity: filters and WS math (wsunet_tpu_torch.ops vs
wsunet_tpu.ops), on the CPU.

Inputs are made from numpy seeds and from the committed p128 covers
(data_ablation/p128/images); both packages get the same arrays.
Tolerance rtol 1e-5 / atol 1e-6: both sides compute in f32, and only the
order of the sums differs (XLA's conv and reductions vs torch's).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wsunet_tpu.ops import filters as jfilters
from wsunet_tpu.ops import ws as jws
from wsunet_tpu_torch.ops import filters as tfilters
from wsunet_tpu_torch.ops import ws as tws

P128 = pathlib.Path(__file__).resolve().parents[1] / "data_ablation" / \
    "p128" / "images"
RTOL, ATOL = 1e-5, 1e-6


def _smooth_u8(rng, shape, alpha=0.0):
    """Smooth synthetic covers (low-frequency pattern + mild noise), with
    LSB replacement at rate alpha (a random alpha share of pixels gets a
    random LSB)."""
    B, H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype("float64")
    out = []
    for _ in range(B):
        f = rng.uniform(0.02, 0.1, 2)
        img = 128 + 60 * np.sin(f[0] * yy + rng.uniform(0, 6)) * \
            np.cos(f[1] * xx) + rng.normal(0, 2, (H, W))
        out.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    x = np.stack(out)
    if alpha:
        sel = rng.random(x.shape) < alpha
        bits = rng.integers(0, 2, x.shape).astype(np.uint8)
        x = np.where(sel, (x & 0xFE) | bits, x).astype(np.uint8)
    return x


def _p128(n=3):
    from PIL import Image
    names = sorted(P128.glob("*.png"))[:n]
    return np.stack([np.array(Image.open(p).convert("L")) for p in names])


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "smooth": _smooth_u8(rng, (2, 40, 56)),
        "stego": _smooth_u8(rng, (2, 40, 56), alpha=0.4),
        "noise": rng.integers(0, 256, (2, 23, 31), dtype=np.uint8),
        "p128": _p128(),
    }


INPUTS = _inputs()


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               rtol=rtol, atol=atol)


def test_named_filters_are_copies():
    for name in jfilters.NAMED_FILTERS_2D:
        np.testing.assert_array_equal(tfilters.NAMED_FILTERS_2D[name],
                                      jfilters.NAMED_FILTERS_2D[name])
        np.testing.assert_array_equal(tfilters.NAMED_FILTERS[name],
                                      jfilters.NAMED_FILTERS[name])
    taps = np.arange(9.0)
    np.testing.assert_array_equal(tfilters.taps_to_kernel2d(taps),
                                  jfilters.taps_to_kernel2d(taps))


@pytest.mark.parametrize("data", sorted(INPUTS))
@pytest.mark.parametrize("kernel", ["KB", "AVG", "AVG9", "1", "asym"])
def test_filter_predict_matches_jax(kernel, data):
    atol = ATOL
    if kernel == "asym":  # a true convolution must flip it
        k = np.random.default_rng(1).normal(size=(3, 3)).astype("float32")
        # signed taps cancel: the f32 sums' order then shows at
        # eps * sum|k x| ~ 6e-8 * 9 * 255 * max|k| ~ 1e-4, absolute
        atol = 1e-4
    else:
        k = jfilters.NAMED_FILTERS_2D[kernel]
    x = INPUTS[data].astype("float32")
    _close(tfilters.filter_predict(torch.from_numpy(x), k),
           jfilters.filter_predict(jnp.asarray(x), k), atol=atol)
    _close(tfilters.conv2d_valid(torch.from_numpy(x[0]), k),
           jfilters.conv2d_valid(jnp.asarray(x[0]), k), atol=atol)


@pytest.mark.parametrize("weighted", [0, 1, -1])
def test_ws_weights_matches_jax(weighted):
    x = INPUTS["p128"].astype("float32")
    _close(tws.ws_weights(torch.from_numpy(x), weighted),
           jws.ws_weights(jnp.asarray(x), weighted))


@pytest.mark.parametrize("data", sorted(INPUTS))
@pytest.mark.parametrize("correct_bias", [False, True])
@pytest.mark.parametrize("weighted", [0, 1, -1])
@pytest.mark.parametrize("kernel", ["KB", "AVG"])
def test_ws_attack_matches_jax(kernel, weighted, correct_bias, data):
    x = INPUTS[data]
    k = jfilters.NAMED_FILTERS_2D[kernel]
    got = tws.ws_attack(torch.from_numpy(x), pixel_kernel=k,
                        weighted=weighted, correct_bias=correct_bias)
    want = jws.ws_attack(jnp.asarray(x), pixel_kernel=k,
                         weighted=weighted, correct_bias=correct_bias)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    _close(got, want)


def test_ws_attack_pixel_estimator_matches_jax():
    x = INPUTS["stego"]
    k = jfilters.NAMED_FILTERS_2D["AVG9"]
    got = tws.ws_attack(torch.from_numpy(x), pixel_estimator=lambda v:
                        tfilters.filter_predict(v, k) + 0.5, weighted=1)
    want = jws.ws_attack(jnp.asarray(x), pixel_estimator=lambda v:
                         jfilters.filter_predict(v, k) + 0.5, weighted=1)
    _close(got, want)


def test_lsb_flip_matches_jax():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        tws.lsb_flip_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jws.lsb_flip_u8(jnp.asarray(x))))


@pytest.mark.parametrize("data", sorted(INPUTS))
def test_ws_estimate_unet_matches_jax(data):
    rng = np.random.default_rng(3)
    x = INPUTS[data].astype("float32")
    x_hat = (x[:, 1:-1, 1:-1] +
             rng.normal(0, 3, x[:, 1:-1, 1:-1].shape)).astype("float32")
    tb, tl1 = tws.ws_estimate_unet(torch.from_numpy(x),
                                   torch.from_numpy(x_hat))
    jb, jl1 = jws.ws_estimate_unet(jnp.asarray(x), jnp.asarray(x_hat))
    _close(tb, jb)
    _close(tl1, jl1)


def test_ws_estimate_unet_casts_before_xor():
    """A non-integer luminance is truncated to uint8 before the LSB flip
    (x = 3.7 -> 3 -> 2), as in the JAX package."""
    x = np.full((1, 3, 3), 3.7, np.float32)
    x_hat = np.zeros((1, 1, 1), np.float32)
    tb, _ = tws.ws_estimate_unet(torch.from_numpy(x), torch.from_numpy(x_hat))
    jb, _ = jws.ws_estimate_unet(jnp.asarray(x), jnp.asarray(x_hat))
    _close(tb, jb)
    np.testing.assert_allclose(float(tb[0]), (3.7 - 2.0) * 3.7, rtol=1e-6)
