"""Kernel B2, the fused WS attack (wsunet_tpu_torch.ops.fused_ws).

On the CPU: its plain version against the Pallas kernel
(``wsunet_tpu.ops.pallas_ws.ws_attack_fused``, interpret mode) and
against the reference formula (``wsunet_tpu.ops.ws_attack``), for every
filter and weighting, at 64x64 and ragged sizes; and the wrapper's
dispatch and checks.  The Triton kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance rtol 1e-4 / atol 1e-6, that of tests/test_pallas_ws.py: the f32
sums are taken in another order (and ws_attack scales by 1/255 and back).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wsunet_tpu.ops import NAMED_FILTERS_2D, ws_attack
from wsunet_tpu.ops.pallas_ws import ws_attack_fused as jax_fused
from wsunet_tpu_torch.ops import fused_ws

RTOL, ATOL = 1e-4, 1e-6
FILTERS = ["KB", "AVG", "AVG9", "1"]
WEIGHTS = [0, 1, -1]


def _batch(shape, seed):
    """Smooth covers, an LSB-replacement stego (alpha 0.4) and uniform
    noise, so both clipped and unclipped estimates occur."""
    B, H, W = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    imgs = []
    for i in range(B):
        kind = i % 3
        if kind == 2:
            imgs.append(rng.integers(0, 256, (H, W), dtype=np.uint8))
            continue
        img = 120 + 50 * np.sin(0.07 * yy + i) * np.cos(0.05 * xx) + \
            rng.normal(0, 2, (H, W))
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        if kind == 1:
            sel = rng.random((H, W)) < 0.4
            img = np.where(sel, (img & 0xFE) | rng.integers(0, 2, (H, W)),
                           img).astype(np.uint8)
        imgs.append(img)
    return np.stack(imgs)


SHAPES = {"64x64": (3, 64, 64), "37x53": (3, 37, 53), "3x3": (3, 3, 3),
          "5x130": (2, 5, 130)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("weighted", WEIGHTS)
@pytest.mark.parametrize("name", FILTERS)
def test_plain_matches_pallas_interpret(name, weighted, shape):
    x = _batch(SHAPES[shape], seed=7)
    got = fused_ws.ws_attack_fused_plain(torch.from_numpy(x), name, weighted)
    want = jax_fused(jnp.asarray(x), name, weighted=weighted, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", WEIGHTS)
@pytest.mark.parametrize("name", FILTERS)
def test_plain_matches_reference_formula(name, weighted):
    x = _batch((4, 64, 64), seed=11)
    got = fused_ws.ws_attack_fused_plain(torch.from_numpy(x), name, weighted)
    want = ws_attack(jnp.asarray(x), pixel_kernel=NAMED_FILTERS_2D[name],
                     weighted=weighted)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_plain_tracks_alpha_on_stego():
    """beta_hat is near 0 on smooth covers and near alpha/2 on LSB
    replacement at alpha = 0.4."""
    x = _batch((6, 96, 96), seed=5)
    beta = fused_ws.ws_attack_fused_plain(torch.from_numpy(x), "KB").numpy()
    assert np.all(beta[0::3] < 0.05), beta
    np.testing.assert_allclose(beta[1::3], 0.2, atol=0.05)


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_batch((3, 37, 53), seed=2))
    fused_ws.reset_launches()
    for w in WEIGHTS:
        np.testing.assert_array_equal(
            fused_ws.ws_attack_fused(x, "KB", w).numpy(),
            fused_ws.ws_attack_fused_plain(x, "KB", w).numpy())
    assert fused_ws.launches == 0


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((2, 8, 8), dtype=torch.float32), TypeError),
    (torch.zeros((2, 8, 8), dtype=torch.int32), TypeError),
    (torch.zeros((8, 8), dtype=torch.uint8), ValueError),
    (torch.zeros((2, 2, 8), dtype=torch.uint8), ValueError),
    (torch.zeros((2, 8, 8, 1), dtype=torch.uint8), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        fused_ws.ws_attack_fused(bad, "KB")


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fused_ws.ws_attack_fused(x, "OLS")
    with pytest.raises(ValueError):
        fused_ws.ws_attack_fused(x, "KB", weighted=2)
    with pytest.raises(ValueError):
        fused_ws.ws_attack_fused(x.to("meta"), "KB")


def test_cost_counts_taps_and_weighting():
    c0 = fused_ws.ws_fused_cost(2, 10, 12, "KB", 0)
    assert c0["bytes"] == 2 * 10 * 12 + 8
    assert c0["ops"] == 2 * 8 * 10 * (2 * 8 - 1 + 5)
    assert fused_ws.ws_fused_cost(2, 10, 12, "1", 0)["ops"] < c0["ops"]
    assert fused_ws.ws_fused_cost(2, 10, 12, "KB", 1)["ops"] > c0["ops"]
