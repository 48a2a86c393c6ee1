"""Tests of wsunet_tpu_torch that need an NVIDIA card (marker ``cuda``).

They skip without a card.  On the card, run them without the JAX
package's conftest (which imports jax, absent there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports no JAX.
"""

import copy

import numpy as np
import pytest
import torch

from wsunet_tpu_torch.models import get_model, init_unet
from wsunet_tpu_torch.ops import NAMED_FILTERS_2D, fused_ws, ws_attack
from wsunet_tpu_torch.serve import UNetWSServer
from wsunet_tpu_torch.ws import attack_sweep, predict_batch

# B2's tolerance (tests/test_pallas_ws.py): f32 sums in another order
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the Triton kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _u8(shape, seed):
    """Smooth images with an LSB-replacement half and uniform noise."""
    B, H, W = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 120 + 50 * np.sin(0.07 * yy[None] + np.arange(B)[:, None, None]) \
        * np.cos(0.05 * xx[None]) + rng.normal(0, 2, (B, H, W))
    x = np.clip(np.round(img), 0, 255).astype(np.uint8)
    sel = (rng.random(x.shape) < 0.4) & (np.arange(B)[:, None, None] % 2 == 1)
    x = np.where(sel, (x & 0xFE) | rng.integers(0, 2, x.shape), x)
    x[::3] = rng.integers(0, 256, x[::3].shape)
    return x.astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 37, 53), (3, 3, 3),
                                   (2, 5, 130), (128, 512, 512)])
def test_kernel_matches_plain(cuda, shape):
    x = torch.from_numpy(_u8(shape, seed=3)).to(cuda)
    for name in NAMED_FILTERS_2D:
        for w in (0, 1, -1):
            fused_ws.reset_launches()
            got = fused_ws.ws_attack_fused(x, name, w)
            assert fused_ws.launches == 1
            want = fused_ws.ws_attack_fused_plain(x, name, w)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda):
    x = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        fused_ws.ws_attack_fused(x.transpose(1, 2), "KB")


@pytest.mark.cuda
def test_attack_sweep_runs_the_kernel(cuda):
    batches = [_u8((8, 128, 128), seed=s) for s in range(3)]
    fused_ws.reset_launches()
    got = attack_sweep(batches, kernel_name="KB", weighted=1)
    assert fused_ws.launches == 3
    want = torch.cat([ws_attack(torch.from_numpy(b).to(cuda),
                                pixel_kernel=NAMED_FILTERS_2D["KB"],
                                weighted=1) for b in batches])
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_unet_card_matches_cpu_and_server_keeps_order(cuda):
    model = init_unet(get_model("unet_1"), seed=0)
    x = _u8((2, 64, 64), seed=5)
    b_cpu, l_cpu = predict_batch(model, x, device="cpu")
    b_gpu, l_gpu = predict_batch(copy.deepcopy(model).to(cuda), x)
    np.testing.assert_allclose(b_gpu.cpu().numpy(), b_cpu.numpy(), atol=1e-5)
    np.testing.assert_allclose(l_gpu.cpu().numpy(), l_cpu.numpy(), rtol=1e-4)
    srv = UNetWSServer(model, size=64)
    imgs = list(_u8((7, 64, 64), seed=6))
    serial = [srv.predict(im) for im in imgs]
    np.testing.assert_allclose(list(srv.predict_many(iter(imgs), depth=3)),
                               serial, rtol=1e-6, atol=1e-7)
