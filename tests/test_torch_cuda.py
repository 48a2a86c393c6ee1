"""Tests of wsunet_tpu_torch that need an NVIDIA card (marker ``cuda``).

They skip without a card.  On the card, run them without the JAX
package's conftest (which imports jax, absent there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports no JAX.
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from wsunet_tpu_torch.analyses import saliency_patch
from wsunet_tpu_torch.models import get_model, init_unet
from wsunet_tpu_torch.ops import (NAMED_FILTERS_2D, fused_reflect_conv,
                                  fused_ws, ws_attack)
from wsunet_tpu_torch.serve import UNetWSServer
from wsunet_tpu_torch.ws import (attack_batches, load_pretrained_unet,
                                 predict_batch)

# B2's tolerance (tests/test_pallas_ws.py): f32 sums in another order
RTOL, ATOL = 1e-4, 1e-6
REPO = pathlib.Path(__file__).resolve().parents[1]
# the JAX package's numbers on the p128 covers and their LSBr stego
GOLDEN = REPO / "weights" / "golden" / "p128_lsbr.npz"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
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
    s0 = saliency_patch(copy.deepcopy(model).to(cuda), img, 30, 33)
    s1 = saliency_patch(copy.deepcopy(fast).to(cuda), img, 30, 33)
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
@pytest.mark.parametrize("shape", [
    (3, 64, 64), (3, 37, 53), (3, 3, 3), (2, 5, 130), (128, 512, 512),
    # widths against the 4-column slots and 16-byte band ends; fewer
    # interior rows than a cluster has blocks; B = 1
    (2, 9, 15), (2, 9, 16), (2, 9, 17), (2, 20, 130), (2, 19, 257),
    (2, 3, 3), (1, 5, 130), (1, 512, 512), (1, 37, 53)])
def test_kernel_matches_plain(cuda, shape):
    x = torch.from_numpy(_u8(shape, seed=3)).to(cuda)
    _b2_matches_plain(x)


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_base(cuda):
    """x[1:] of a (4, 37, 53) batch starts 1,961 bytes into its storage,
    so no band starts on a 16-byte boundary."""
    x = torch.from_numpy(_u8((4, 37, 53), seed=4)).to(cuda)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _b2_matches_plain(x)


@pytest.mark.cuda
def test_kernel_is_deterministic_and_graph_safe(cuda):
    """Two calls, and a CUDA-graph replay, give bitwise-equal results."""
    x = torch.from_numpy(_u8((16, 256, 256), seed=9)).to(cuda)
    for name in NAMED_FILTERS_2D:
        for w in (0, 1, -1):
            eager = fused_ws.ws_attack_fused(x, name, w)
            assert torch.equal(eager, fused_ws.ws_attack_fused(x, name, w))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fused_ws.ws_attack_fused(x, name, w)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fused_ws.ws_attack_fused(x, name, w)
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, eager), (name, w)


@pytest.mark.cuda
def test_reciprocal_is_ieee_division(cuda):
    """B2's w = 1/(5 + var) skips the IEEE division's general-case code; at
    every value 5 + var takes (var = k/64, 0 <= k <= 1,040,400) it equals
    the IEEE quotient 1/d, bit for bit."""
    from wsunet_tpu_torch.ops import _cuda_build

    lib = fused_ws._bind_types(
        _cuda_build.load_all(_cuda_build.SOURCES)[fused_ws.SOURCE])
    d_np = (5.0 + np.arange(1_040_401, dtype=np.float64) / 64).astype(
        np.float32)
    d = torch.from_numpy(d_np).to(cuda)
    out = torch.empty_like(d)
    assert lib.ws_fused_recip(d.data_ptr(), out.data_ptr(), d.numel(),
                              torch.cuda.current_stream().cuda_stream) == 0
    want = np.float32(1.0) / d_np
    np.testing.assert_array_equal(out.cpu().numpy(), want)


def _b2_matches_plain(x):
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
def test_attack_sweep_pinned_uploads_keep_results_and_order(cuda):
    """numpy batches go through two reused pinned buffers: five batches of
    three sizes (a buffer grows, then is reused) give, in order, what the
    plain path gives on each batch uploaded on its own."""
    batches = [_u8(s, seed=i) for i, s in enumerate(
        [(8, 64, 64), (3, 64, 64), (8, 96, 96), (8, 64, 64), (2, 64, 64)])]
    got = attack_batches(batches, kernel_name="AVG", weighted=-1)
    want = torch.cat([ws_attack(torch.from_numpy(b).to(cuda),
                                pixel_kernel=NAMED_FILTERS_2D["AVG"],
                                weighted=-1) for b in batches])
    assert got.shape == (29,)
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=RTOL, atol=ATOL)
    tensors = attack_batches([torch.from_numpy(b) for b in batches],
                             kernel_name="AVG", weighted=-1)
    np.testing.assert_array_equal(got, tensors)


@pytest.mark.cuda
def test_attack_sweep_runs_the_kernel(cuda):
    batches = [_u8((8, 128, 128), seed=s) for s in range(3)]
    fused_ws.reset_launches()
    got = attack_batches(batches, kernel_name="KB", weighted=1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("fast_conv", [False, True])
def test_trained_unet_on_card_matches_golden(cuda, fast_conv):
    """The exported LSBR unet_2 on the card against the JAX package's f32
    beta_hat and l1 (tests/test_torch_unet.py's bounds for trained
    weights: |d beta| <= 1e-5, relative d l1 <= 1e-4)."""
    gold = np.load(GOLDEN)
    model, _ = load_pretrained_unet(REPO / "weights" / "unet" / "LSBR",
                                    str(gold["run"]), fast_conv=fast_conv)
    assert next(model.parameters()).is_cuda
    px = gold["pixels"].reshape(-1, 128, 128)
    fused_reflect_conv.reset_launches()
    out = [predict_batch(model, px[i:i + 8]) for i in range(0, len(px), 8)]
    beta = torch.cat([o[0] for o in out]).cpu().numpy().reshape(3, 64)
    l1 = torch.cat([o[1] for o in out]).cpu().numpy().reshape(3, 64)
    assert fused_reflect_conv.launches == (240 if fast_conv else 0)
    np.testing.assert_allclose(beta, gold["beta/UNet"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(l1, gold["l1"], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("model, kw, tol", [
    ("KB", {"kernel_name": "KB"}, (RTOL, ATOL)),
    ("KB-w", {"kernel_name": "KB", "weighted": 1}, (RTOL, ATOL)),
    ("KB-sca", {"kernel_name": "KB", "sca": True}, (1e-4, 1e-5))])
def test_trained_path_filters_on_card_match_golden(cuda, model, kw, tol):
    gold = np.load(GOLDEN)
    px = gold["pixels"].reshape(-1, 128, 128)
    fused_ws.reset_launches()
    got = attack_batches([px[i:i + 8] for i in range(0, len(px), 8)], **kw)
    assert fused_ws.launches == (0 if kw.get("sca") else 24)
    np.testing.assert_allclose(got.reshape(3, 64), gold[f"beta/{model}"],
                               rtol=tol[0], atol=tol[1])


# the JAX package's B0 and OLS numbers on the same images
GOLDEN_B0 = REPO / "weights" / "golden" / "p128_b0.npz"
B0_DIR = REPO / "weights" / "b0" / "LSBR"


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1])
def test_trained_b0_on_card_matches_golden(cuda, index):
    """Both exported LSBR B0 runs, f32 with TF32 off, on the 192 golden
    images in batches of 8: P(stego) within 1e-4 of JAX's
    (tests/test_torch_b0.py's bound)."""
    from wsunet_tpu_torch.detect import infer_b0, load_pretrained_b0

    gold = np.load(GOLDEN_B0)
    run, label = str(gold["runs"][index]), str(gold["labels"][index])
    model, config = load_pretrained_b0(B0_DIR, run)
    assert next(model.parameters()).is_cuda
    px = np.load(GOLDEN)["pixels"].reshape(-1, 128, 128)
    got = torch.cat([infer_b0(model, px[i:i + 8],
                              use_lsbr_reference=config["lsbr_reference"])
                     for i in range(0, len(px), 8)])
    np.testing.assert_allclose(got.cpu().numpy().reshape(3, 64),
                               gold[f"prob/{label}"], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b0_card_matches_cpu_at_512(cuda, index, dtype):
    """Both runs at 512x512 (B=2, seeded smooth covers and their LSB
    replacement): the card's f32 within 1e-4 of the CPU's f32; the card's
    bf16 no further from the CPU's f32 than 1.25 times the JAX package's
    own bf16 distance from its f32 on the golden covers (bf16 loses the LSB
    signal in both packages alike; one image sets the maximum)."""
    from wsunet_tpu_torch.detect import infer_b0, load_pretrained_b0

    gold = np.load(GOLDEN_B0)
    run, label = str(gold["runs"][index]), str(gold["labels"][index])
    rng = np.random.default_rng(index)
    yy, xx = np.mgrid[0:512, 0:512]
    img = 128 + 60 * np.sin(0.03 * yy) * np.cos(0.05 * xx) + \
        rng.normal(0, 2, (512, 512))
    cover = np.clip(np.round(img), 0, 255).astype(np.uint8)
    flip = rng.random(cover.shape) < 0.2
    stego = np.where(flip, cover ^ 1, cover).astype(np.uint8)
    px = np.stack([cover, stego])
    cpu, config = load_pretrained_b0(B0_DIR, run, device="cpu")
    want = infer_b0(cpu, px, use_lsbr_reference=config["lsbr_reference"],
                    device="cpu").numpy()
    model, _ = load_pretrained_b0(B0_DIR, run, compute_dtype=dtype)
    got = infer_b0(model, px,
                   use_lsbr_reference=config["lsbr_reference"]).cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        bound = np.abs(gold[f"prob_bf16/{label}"] -
                       gold[f"prob/{label}"][0]).max()
        assert np.isfinite(got).all() and \
            np.abs(got - want).max() <= 1.25 * bound


@pytest.mark.cuda
def test_ols_on_card_matches_golden(cuda):
    """OLS fitted on the card (exact float64 normal equations) against
    JAX's taps and beta_hat (tests/test_torch_ols.py's bounds)."""
    from wsunet_tpu_torch.ops import ols

    gold = np.load(GOLDEN_B0)
    px = torch.from_numpy(np.load(GOLDEN)["pixels"]).to(cuda)
    taps = ols.fit_ols(px[0])
    np.testing.assert_allclose(taps, gold["ols/taps"], rtol=0, atol=2e-3)
    kernel = ols.ols_kernel2d(px[0])[::-1, ::-1]
    beta = attack_batches(list(px.reshape(-1, 8, 128, 128)),
                          pixel_kernel=kernel)
    np.testing.assert_allclose(beta.reshape(3, 64), gold["beta/OLS"],
                               rtol=0, atol=2e-4)
    channels = tuple(gold["color/channels"])
    x4 = torch.from_numpy(gold["color/pixels"]).to(cuda).permute(
        0, 1, 4, 2, 3)
    kernels = ols.ols_color_kernels(x4[0], channels)
    np.testing.assert_allclose(ols.fit_ols_color(x4[0], channels),
                               gold["color/taps"], rtol=0, atol=1e-2)
    beta = torch.stack([ws_attack(
        x[:, channels[-1]],
        pixel_estimator=lambda _, x=x: ols.ols_color_predict(x.float(),
                                                             kernels))
        for x in x4])
    np.testing.assert_allclose(beta.cpu().numpy(), gold["color/beta"],
                               rtol=0, atol=1e-3)


GOLDEN_TRAIN = REPO / "weights" / "golden" / "p128_train_step.npz"


def _golden_train_step(device):
    """(loss, gradients in the Flax layout) of the golden training step:
    the committed LSBR weights, JAX's draws, batch 0."""
    import json

    from wsunet_tpu_torch.models import (flax_params_from_unet_state_dict,
                                         unet_state_dict_from_flax)
    from wsunet_tpu_torch.train import get_loss, load_params
    from wsunet_tpu_torch.train.checkpoint import flatten_tree
    from wsunet_tpu_torch.train.train_unet import Sampler

    z = np.load(GOLDEN_TRAIN)
    cfg = json.loads(str(z["config"]))
    run = REPO / "weights" / "unet" / "LSBR" / str(z["run"])
    m = get_model(cfg["network"])
    m.load_state_dict(unet_state_dict_from_flax(load_params(run)[0]))
    m = m.to(device).train()
    fn = get_loss(cfg["loss"], per_image=True,
                  loss_lambda=cfg["loss_lambda"])
    draws = {k[len("draws/0/"):]: torch.from_numpy(z[k]) for k in z.files
             if k.startswith("draws/0/")}
    draws = {k: (v.long() if v.dtype == torch.int32 else v).to(device)
             for k, v in draws.items()}
    loss = Sampler(m, fn, cfg["stego_method"], cfg["alpha"],
                   crop=cfg["crop"], augment=cfg["augment"],
                   cover_fraction=cfg["cover_fraction"]).loss(
        torch.from_numpy(z["pixels"][0]).to(device),
        torch.from_numpy(z["mask"][0]).to(device), draws)[0]
    loss.backward()
    grads = flatten_tree(flax_params_from_unet_state_dict(
        {k: p.grad for k, p in m.named_parameters()}))
    return float(loss), grads, z


@pytest.mark.cuda
def test_golden_train_step_on_card(cuda):
    """The training step on the card against JAX's golden numbers (loss
    rel 1e-4, gradients max|d|/max|g| 1e-3) and against the CPU port
    (the same bounds)."""
    loss, grads, z = _golden_train_step(cuda)
    assert abs(loss / float(z["loss"]) - 1) <= 1e-4
    for k in z.files:
        if k.startswith("grad/"):
            want = z[k]
            got = grads[k[len("grad/"):]]
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), k
    cpu_loss, cpu_grads, _ = _golden_train_step("cpu")
    assert abs(loss / cpu_loss - 1) <= 1e-4
    for k, want in cpu_grads.items():
        assert np.abs(grads[k] - want).max() <= 1e-3 * np.abs(want).max(), k


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.4, 0.01])
def test_hillr_on_card_is_the_cpus(cuda, alpha):
    from wsunet_tpu_torch.data.simulate import hillr_simulate

    x = torch.from_numpy(np.load(GOLDEN)["pixels"][0, :16])
    got = hillr_simulate(x.to(cuda), alpha).cpu()
    assert torch.equal(got, hillr_simulate(x, alpha))


@pytest.mark.cuda
def test_train_names_on_card_writes_a_servable_run(cuda, tmp_path):
    """Two epochs of two steps on the card from .npy covers; the run's
    best.npz serves a batch."""
    from wsunet_tpu_torch.train.train_unet import train_names

    px = np.load(GOLDEN)["pixels"][0, :12]
    (tmp_path / "images").mkdir()
    names = []
    for i, img in enumerate(px):
        names.append(f"images/{i}.npy")
        np.save(tmp_path / names[-1], img)
    cfg = dict(network="unet_1", crop=64, batch_size=4, steps_per_epoch=2,
               num_epochs=2, val_steps=1, augment=True,
               lr_schedule="cosine", drop_rate=0.1)
    exp = train_names(cfg, tmp_path, names[:8], names[8:], tmp_path / "runs",
                      device="cuda", reader=np.load)
    assert exp.name.split("-")[1] == "cuda"
    model, _ = load_pretrained_unet(exp.parent, exp.name, device="cuda")
    beta, l1 = predict_batch(model, px[:4], device="cuda")
    assert bool(torch.isfinite(beta).all()) and bool(torch.isfinite(l1).all())


GOLDEN_B0_TRAIN = REPO / "weights" / "golden" / "p128_b0_train_step.npz"


def _golden_b0_step(device):
    """The B0 golden step in the committed recipe (freeze_bn) on
    ``device``, on JAX's draws: (loss, gradients in the Flax layout)."""
    import json

    from wsunet_tpu_torch.models import (b0_state_dict_from_flax,
                                         flax_b0_params_from_state_dict)
    from wsunet_tpu_torch.train import load_params
    from wsunet_tpu_torch.train import train_b0
    from wsunet_tpu_torch.train.checkpoint import flatten_tree

    z = np.load(GOLDEN_B0_TRAIN)
    cfg = train_b0.B0TrainConfig.validate(json.loads(str(z["config"])))
    model = train_b0.build_model(cfg)
    model.load_state_dict(b0_state_dict_from_flax(*load_params(
        REPO / "weights" / "b0" / "LSBR" / str(z["run"]))))
    model.to(device).eval()
    d = {k[len("draws/0/"):]: torch.from_numpy(z[k]).to(device)
         for k in z.files if k.startswith("draws/0/")}
    d = {k: v.long() if v.dtype == torch.int32 else v for k, v in d.items()}
    sampler = train_b0.B0Sampler(model, cfg["stego_method"], cfg["alpha"],
                                 crop=cfg["crop"], augment=cfg["augment"])
    loss = sampler.loss(torch.from_numpy(z["pixels"][0]).to(device),
                        torch.from_numpy(z["mask"][0]).to(device), d)[0]
    loss.backward()
    grads = flatten_tree(flax_b0_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})[0])
    return float(loss), grads, z


@pytest.mark.cuda
def test_golden_b0_train_step_on_card(cuda):
    """The B0 step (committed recipe) on the card against JAX's golden
    numbers and against the CPU port on the same draws: loss rel 1e-4,
    gradients max|d|/max|g| 1e-3."""
    loss, grads, z = _golden_b0_step(cuda)
    assert abs(loss / float(z["loss"]) - 1) <= 1e-4
    for k in z.files:
        if k.startswith("grad/"):
            want, got = z[k], grads[k[len("grad/"):]]
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), k
    cpu_loss, cpu_grads, _ = _golden_b0_step("cpu")
    assert abs(loss / cpu_loss - 1) <= 1e-4
    for k, want in cpu_grads.items():
        assert np.abs(grads[k] - want).max() <= \
            1e-3 * max(np.abs(want).max(), 1e-30), k


@pytest.mark.cuda
@pytest.mark.parametrize("inbayer", [None, "01"])
def test_filters_eval_step_on_card_is_the_cpus(cuda, inbayer):
    """filters-eval's step (KB and AVG) on the card and on the CPU on the
    64 golden covers: MAE and wMAE rel 1e-5."""
    from wsunet_tpu_torch.ops.filters import NAMED_FILTERS, taps_to_kernel2d
    from wsunet_tpu_torch.ws import mae_wmae

    x = torch.from_numpy(np.load(GOLDEN)["pixels"][0])
    for name in ("KB", "AVG"):
        k = taps_to_kernel2d(NAMED_FILTERS[name])
        got = mae_wmae(x.to(cuda), k, inbayer=inbayer)
        want = mae_wmae(x, k, inbayer=inbayer)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-5)


@pytest.mark.cuda
def test_train_b0_names_on_card_writes_a_loadable_run(cuda, tmp_path):
    """Two epochs of two B0 steps on the card from .npy covers (batch
    statistics and head dropout live); the run's best.npz loads and
    scores a batch."""
    from wsunet_tpu_torch.detect import infer_b0, load_pretrained_b0
    from wsunet_tpu_torch.train.train_b0 import train_names

    px = np.load(GOLDEN)["pixels"][0, :8]
    (tmp_path / "images").mkdir()
    names = []
    for i, img in enumerate(px):
        names.append(f"images/{i}.npy")
        np.save(tmp_path / names[-1], img)
    cfg = dict(crop=64, batch_size=2, steps_per_epoch=2, num_epochs=2,
               val_steps=1, augment=True, alpha=[0.1, 0.05],
               stem_init="highpass", parity_features=True,
               quadratic_stem=True, compute_dtype="float32")
    exp = train_names(cfg, tmp_path, names[:6], names[6:], tmp_path / "runs",
                      device="cuda", reader=np.load)
    assert exp.name.split("-")[1] == "cuda"
    model, _ = load_pretrained_b0(exp.parent, exp.name, device="cuda")
    p = infer_b0(model, px[:4], device="cuda")
    assert p.shape == (4,) and bool(torch.isfinite(p).all())


# the JAX package's analyses on the p128 covers and their LSBr stego
GOLDEN_ANALYSES = REPO / "weights" / "golden" / "p128_analyses.npz"
UNET_DIR = REPO / "weights" / "unet"


def _analyses_files(root):
    """The golden covers and their stego at the golden alpha as .npy files
    under ``root``: (golden arrays, cover names, stego names)."""
    gold = np.load(GOLDEN_ANALYSES)
    lsbr = np.load(GOLDEN)
    s = list(lsbr["sets"]).index(str(float(gold["alpha"])))
    (root / "images").mkdir()
    (root / "stego").mkdir()
    names_c, names_s = [], []
    for i, (c, st) in enumerate(zip(lsbr["pixels"][0], lsbr["pixels"][s])):
        names_c.append(f"images/{i:02d}.npy")
        names_s.append(f"stego/{i:02d}.npy")
        np.save(root / names_c[-1], c)
        np.save(root / names_s[-1], st)
    return gold, names_c, names_s


@pytest.mark.cuda
@pytest.mark.parametrize("fast_conv", [False, True])
def test_analyses_on_card_match_golden(cuda, tmp_path, fast_conv):
    """correlation's rows, error-boxes' statistics, the difference images
    and the saliency patches on the card against the JAX package's, at
    tests/test_torch_analyses.py's bounds (saliency: 1e-4, the bound of
    a route whose convs sum in another order than XLA's CPU conv; the
    U-Net per pixel 2.55e-4: 1.07e-4 seen on the card)."""
    from wsunet_tpu_torch.analyses.contour import difference_image
    from wsunet_tpu_torch.analyses.correlation import (correlation_rows,
                                                       unet_runs)
    from wsunet_tpu_torch.analyses.error_boxes import (box_stats,
                                                       residual_populations)
    from wsunet_tpu_torch.analyses.saliency import (saliency_patches,
                                                    sobel_locations)

    gold, names_c, names_s = _analyses_files(tmp_path)
    unets = unet_runs(UNET_DIR, ["dropout", "LSBR", "HILLR"])
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    rows = correlation_rows(tmp_path, names_c, names_s, unets=unets,
                            fast_conv=fast_conv, reader=np.load)
    assert fused_reflect_conv.launches == (3 * 8 * 10 if fast_conv else 0)
    labels = [str(m) for m in gold["correlation_models"]]
    assert [r["model_name"] for r in rows[::64]] == labels
    for k, label in enumerate(labels):
        part = rows[64 * k:64 * (k + 1)]
        rtol = 1e-4 if label.startswith("UNet") else 1e-5
        # atol: the statistic's f32 rounding, at correlations down to 5e-8
        np.testing.assert_allclose([r["correlation"] for r in part],
                                   gold[f"correlation/{label}"], rtol=rtol,
                                   atol=1e-7)
        p = np.array([r["p-value"] for r in part])
        want = gold[f"p-value/{label}"]
        assert ((p == 0) == (want == 0)).all()
        np.testing.assert_allclose(np.log(p[want > 0]),
                                   np.log(want[want > 0]), rtol=1e-3)
    pops = residual_populations(
        tmp_path, names_c, unets=[("UNet_l1", unets[0][1]),
                                  ("UNet_l1ws", unets[1][1])],
        fast_conv=fast_conv, reader=np.load)
    table = box_stats(pops, "KB")
    assert [r["Type"] for r in table] == list(gold["boxes/Type"])
    for r, want in zip(table, gold["boxes/stats"]):
        unet = r["Type"].startswith("UNet")
        np.testing.assert_allclose(
            [r[c] for c in gold["boxes/columns"]], want,
            rtol=1e-4 if unet else 1e-5, atol=2.55e-4 if unet else 0)
    names = [str(n) for n in gold["names"]]
    for i, name in enumerate(gold["diff/names"]):
        f = tmp_path / names_c[names.index(str(name))]
        kb = difference_image(f, "KB", reader=np.load)
        np.testing.assert_allclose(kb, gold["diff/KB"][i], rtol=0,
                                   atol=1e-4)
        unet = difference_image(f, "UNet", UNET_DIR, "LSBR",
                                fast_conv=fast_conv, reader=np.load)
        np.testing.assert_allclose(unet, gold["diff/UNet"][i], rtol=0,
                                   atol=2.55e-4)
    f = tmp_path / names_c[names.index(str(gold["saliency/name"]))]
    points = [tuple(map(int, p)) for p in gold["saliency/points"]]
    patches = saliency_patches(f, points, UNET_DIR, "LSBR",
                               fast_conv=fast_conv, reader=np.load)
    np.testing.assert_allclose(np.stack(patches), gold["saliency/patches"],
                               rtol=0, atol=1e-4)
    locs = sobel_locations(f, reader=np.load)
    assert list(locs) == list(gold["sobel/keys"])
    assert [tuple(map(int, v)) for v in locs.values()] == \
        [tuple(map(int, v)) for v in gold["sobel/points"]]
    assert fused_ws.launches == 0


@pytest.mark.cuda
def test_serve_loop_on_b1(cuda, tmp_path):
    """``serve``'s serial loop over .npy paths, bf16 on B1: 9 wgmma + 1
    direct launches a request, the numbers of ``UNetWSServer.predict``,
    and an inline error for a wrong-shape image."""
    from wsunet_tpu_torch.serve import serve_lines

    gold = np.load(GOLDEN)
    model, _ = load_pretrained_unet(UNET_DIR / "LSBR", str(gold["run"]),
                                    compute_dtype=torch.bfloat16,
                                    fast_conv=True)
    srv = UNetWSServer(model, size=128)
    paths = []
    for i, img in enumerate(gold["pixels"][0][:3]):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], img if i != 1 else img[:64])
    fused_reflect_conv.reset_launches()
    out = list(serve_lines(srv, [p + "\n" for p in paths], reader=np.load))
    assert fused_reflect_conv.launches_by_variant == {
        "wgmma": 18, "direct": 2, "fma": 0}
    assert out[1]["error"].startswith("ValueError: expected 128x128")
    for i in (0, 2):
        assert (out[i]["beta_hat"], out[i]["l1"]) == \
            srv.predict(gold["pixels"][0][i])


# --- the parallel path (wsunet_tpu_torch.parallel) ------------------------

@pytest.fixture
def one_rank_group(cuda, tmp_path, request):
    """A one-rank process group on the card (backend from the test's
    parameter), torn down after the test."""
    import torch.distributed as dist

    from wsunet_tpu_torch.parallel.distributed import distributed_init

    assert distributed_init(init_method=f"file://{tmp_path / 'rdzv'}",
                            world_size=1, rank=0,
                            backend=request.param) is False
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [0, 1, -1])
def test_ws_attack_spatial_on_the_card(cuda, weighted):
    """The row-sharded attack without a group, on CUDA tensors, against
    B2 and the plain attack (B2's tolerance)."""
    from wsunet_tpu_torch.parallel.spatial import ws_attack_spatial

    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randint(0, 256, (4, 256, 256), dtype=torch.uint8, device=cuda,
                      generator=g)
    kb = NAMED_FILTERS_2D["KB"]
    got = ws_attack_spatial(x, kb, weighted=weighted)
    assert got.is_cuda
    for want in (fused_ws.ws_attack_fused(x, "KB", weighted),
                 ws_attack(x, pixel_kernel=kb, weighted=weighted)):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("one_rank_group", ["nccl", "gloo"], indirect=True)
def test_infer_unet_spatial_on_a_one_rank_group(one_rank_group, cuda):
    """The halo-exchanged U-Net on the card, under nccl and under gloo
    (its halo rows CUDA tensors on both), against ``infer_unet`` at
    tests/test_multichip.py's 1e-3 (0..255)."""
    from wsunet_tpu_torch.parallel.spatial import infer_unet_spatial
    from wsunet_tpu_torch.ws import infer_unet

    gold = np.load(GOLDEN)
    model, _ = load_pretrained_unet(REPO / "weights" / "unet" / "LSBR",
                                    str(gold["run"]))
    x = torch.from_numpy(gold["pixels"][0, :4]).to(cuda).float()
    got = infer_unet_spatial(model, x)
    assert got.is_cuda and got.shape == (4, 126, 126)
    torch.testing.assert_close(got, infer_unet(model, x), rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("one_rank_group", ["nccl", "gloo"], indirect=True)
def test_collectives_keep_cuda_tensors_on_the_card(one_rank_group, cuda):
    """Every collective of ``Mesh`` takes CUDA tensors on both backends
    and gives them back on the card (gloo copies them through the host
    itself), and ``replicate`` takes host arrays on both (nccl: sent
    from the card)."""
    from wsunet_tpu_torch.parallel import get_mesh, replicate

    mesh = get_mesh()
    t = torch.arange(6.0, device=cuda, requires_grad=True)
    for out in (mesh.all_reduce(t), mesh.gather_batch(t),
                *mesh.all_gather(t), mesh.all_reduce_autograd(t)):
        assert out.is_cuda
        torch.testing.assert_close(out.detach(), t.detach())
    mesh.all_reduce_autograd(t).sum().backward()
    torch.testing.assert_close(t.grad, torch.ones_like(t))
    model = torch.nn.Linear(3, 2).to(cuda)
    before = [p.detach().clone() for p in model.parameters()]
    replicate(mesh, model)
    for p, q in zip(model.parameters(), before):
        assert torch.equal(p, q)
    tree = replicate(mesh, {"a": np.arange(3.0), "b": [t.detach()]})
    np.testing.assert_array_equal(tree["a"], np.arange(3.0))
    assert tree["b"][0].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, want", [
    (torch.bfloat16, {"wgmma": 9, "direct": 1, "fma": 0}),
    (torch.float32, {"wgmma": 0, "direct": 1, "fma": 9})])
def test_bench_headline_step_launches_b1_ten_times(cuda, monkeypatch, dtype,
                                                   want):
    """The bench's headline step on its default route (B1) launches B1 10
    times a forward, and gives finite (beta_hat, l1) near the cuDNN
    route's."""
    from wsunet_tpu_torch import bench

    monkeypatch.delenv("WSUNET_BENCH_FAST_CONV", raising=False)
    model = bench.build_model(dtype, bench.conv_route(), cuda)
    x = torch.from_numpy(_u8((2, 512, 512), seed=11)).to(cuda)
    fused_reflect_conv.reset_launches()
    beta, l1 = bench.make_step(model, cuda)(x)
    assert fused_reflect_conv.launches_by_variant == want
    assert torch.isfinite(beta).all() and torch.isfinite(l1).all()
    plain = bench.build_model(dtype, False, cuda)
    beta0, l10 = bench.make_step(plain, cuda)(x)
    # bf16: the bf16 server's distance from f32 (chip_smoke.py phase 4)
    atol = 5e-3 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(beta, beta0, rtol=0, atol=atol)


@pytest.mark.cuda
def test_bench_ws_fused_parity_on_card(cuda):
    """The bench's ws_fused section: B2 against the plain attack for KB
    and AVG x every weighting (a gap beyond B2's tolerance raises), and a
    device time from a CUDA graph."""
    from wsunet_tpu_torch import bench

    fused_ws.reset_launches()
    out = bench._bench_ws_fused(cuda, iters=10, batch_size=8)
    assert set(out["parity_by_mode"]) == {
        f"{k}_w{w}" for k in ("KB", "AVG") for w in (0, 1, -1)}
    assert out["max_abs_diff_vs_plain"] == max(out["parity_by_mode"].values())
    assert out["max_abs_diff_vs_plain"] < 1e-4
    assert out["ms_per_call"] > 0 and out["images_per_sec"] > 0
    assert out["window_ms"] == pytest.approx(10 * out["ms_per_call"])
    # 6 parity calls, 3 warm-up calls and the 10 captured in the graph
    assert fused_ws.launches == 19


def _event_ns(event, what):
    fn = getattr(event, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(
        event, f"{what}_us")() * 1000)


@pytest.mark.cuda
def test_program_span_holds_its_kernels_on_the_device_clock(cuda):
    """A program span (``utils.profiling``) around a launched kernel and
    its ``synchronize()`` holds the kernel's interval in the profiler's
    device events: the recorder's ``time.time_ns()`` stamps share the
    clock of the trace's device timeline."""
    from wsunet_tpu_torch.utils import profiling

    x = torch.randn(2048, 2048, device=cuda)
    (x @ x).sum().item()
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with profiling.span("matmul"):
                x @ x
                torch.cuda.synchronize(cuda)
        span, = profiling.recorded()["spans"]
    finally:
        profiling.clear()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels
    for k in kernels:
        start = _event_ns(k, "start")
        assert span["start_ns"] <= start
        assert start + _event_ns(k, "duration") <= span["end_ns"]
