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

from wsunet_tpu_torch.analyses import unet_saliency
from wsunet_tpu_torch.models import get_model, init_unet
from wsunet_tpu_torch.ops import (NAMED_FILTERS_2D, fused_reflect_conv,
                                  fused_ws, ws_attack)
from wsunet_tpu_torch.serve import UNetWSServer
from wsunet_tpu_torch.ws import attack_sweep, predict_batch

# B2's tolerance (tests/test_pallas_ws.py): f32 sums in another order
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the Triton and CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _b1_within_tolerance(got, want):
    """B1 against its plain version run in f32 on the same inputs.  f32:
    rtol 1e-4 / atol 1e-4 (sums of up to 9*C terms in another order).
    bf16: one bf16 ulp of the output (the kernel rounds its f32 sum once)
    plus atol 1e-4 for values near 0."""
    if got.dtype == torch.bfloat16:
        tol = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)
    else:
        tol = 1e-4 * want.abs()
    return bool(((got.float() - want).abs() <= tol + 1e-4).all())


def _xwb(shape, cout, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[-1]
    x = torch.randn(shape, device=device, generator=g)
    w = torch.randn((3, 3, C, cout), device=device, generator=g) / (3 * C ** .5)
    b = 0.1 * torch.randn(cout, device=device, generator=g)
    return x.to(dtype), w.to(dtype), b.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, cout", [
    ((3, 37, 29, 5), 7), ((1, 2, 2, 1), 3), ((2, 9, 130, 64), 64),
    ((2, 64, 64, 1), 64), ((1, 32, 32, 256), 128), ((1, 20, 20, 9), 130),
    # each variant's edges: C = 16 (the wgmma/fma boundary), 24, 48, 80;
    # Cout = 8, 130, 192 against 64/128-wide tiles; W = 29 against 64-column
    # runs; H = W = 2; bf16 C = 130 (not a multiple of 8: direct)
    ((1, 6, 40, 16), 64), ((1, 6, 40, 24), 130), ((1, 6, 40, 48), 64),
    ((1, 6, 40, 80), 192), ((1, 7, 33, 64), 8), ((2, 9, 29, 64), 64),
    ((1, 2, 2, 64), 128), ((1, 9, 9, 130), 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_b1_matches_plain(cuda, shape, cout, dtype, relu):
    x, w, b = _xwb(shape, cout, dtype, cuda, seed=sum(shape) + cout)
    fused_reflect_conv.reset_launches()
    got = fused_reflect_conv.conv3x3_reflect_fused(x, w, b, relu=relu)
    assert fused_reflect_conv.launches == 1
    variant = fused_reflect_conv._variant(shape[-1], dtype)
    assert fused_reflect_conv.launches_by_variant[variant] == 1
    torch.cuda.synchronize()
    want = fused_reflect_conv.conv3x3_reflect_fused_plain(
        x.float(), w.float(), b.float(), relu)
    assert got.dtype == dtype and got.shape == want.shape
    assert _b1_within_tolerance(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, want", [
    (torch.bfloat16, {"wgmma": 9, "direct": 1, "fma": 0}),
    (torch.float32, {"wgmma": 0, "direct": 1, "fma": 9})])
def test_unet2_forward_launches_by_variant(cuda, dtype, want):
    """One unet_2 forward through B1: e1.conv1 on the direct kernel, the 9
    other convs on wgmma (bf16) or fma (f32), and finite outputs."""
    model = init_unet(get_model("unet_2", fast_conv=True), seed=0)
    model = model.to(device=cuda, dtype=dtype)
    model.compute_dtype = dtype
    x = torch.from_numpy(_u8((2, 64, 64), seed=8)).to(cuda)
    fused_reflect_conv.reset_launches()
    beta, l1 = predict_batch(model, x)
    assert fused_reflect_conv.launches_by_variant == want
    assert torch.isfinite(beta).all() and torch.isfinite(l1).all()


@pytest.mark.cuda
def test_b1_rejects_non_contiguous(cuda):
    x, w, b = _xwb((2, 8, 8, 4), 4, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        fused_reflect_conv.conv3x3_reflect_fused(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        fused_reflect_conv.conv3x3_reflect_fused(x, w.cpu(), b)


@pytest.mark.cuda
def test_fast_conv_unet_on_card(cuda):
    """unet_1 through B1 (6 launches a forward) against cuDNN's route, f32,
    and the bf16 server on B1; the saliency gradient through B1."""
    model = init_unet(get_model("unet_1"), seed=0)
    fast = copy.deepcopy(model)
    fast.fast_conv = True
    x = _u8((2, 64, 64), seed=5)
    b0, l0 = predict_batch(copy.deepcopy(model).to(cuda), x)
    fused_reflect_conv.reset_launches()
    b1, l1 = predict_batch(copy.deepcopy(fast).to(cuda), x)
    assert fused_reflect_conv.launches == 6
    np.testing.assert_allclose(b1.cpu().numpy(), b0.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(l1.cpu().numpy(), l0.cpu().numpy(), rtol=1e-4)
    srv = UNetWSServer(fast, size=64)
    got = srv.predict(x[0])
    assert np.all(np.isfinite(got)) and abs(got[0] - float(b0[0])) < 5e-3
    img = _u8((1, 64, 64), seed=7)[0]
    s0 = unet_saliency(copy.deepcopy(model).to(cuda), img, 30, 33)
    s1 = unet_saliency(copy.deepcopy(fast).to(cuda), img, 30, 33)
    # a max-pool near-tie can move the gradient (tests/test_torch_saliency)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-3 * np.abs(s0).max())


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
