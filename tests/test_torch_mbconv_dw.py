"""Kernel B3's CPU side (``ops.fused_mbconv_dw``): its plain version
against the B0 module's own composition at each block shape of
B0 without stem stride, the route ``models.b0._MBConv`` takes, the
launch plan, the cost and the benchmark's reader of B3's roofline.  The
kernel itself runs only on the card (tests/test_torch_cuda.py).

Tolerance of the plain version against the composition: y within rtol
1e-5 / atol 1e-6 (the norm as a scale and shift, and a conv with its
padding made by F.pad, round differently from F.batch_norm and a conv
that pads itself: a few ulps), the sums within rtol 1e-5 / atol 1e-5
(sums of up to 4,489 such values)."""

import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity

from wsunet_tpu_torch.models import b0 as b0_mod
from wsunet_tpu_torch.models import get_b0
from wsunet_tpu_torch.ops import fused_mbconv_dw as b3
from wsunet_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
B0NS = json.loads((REPO / "port_bench" / "configs" /
                   "efficientnet_b0_nostride.json").read_text())


def _reader():
    spec = importlib.util.spec_from_file_location(
        "b3_roofline", REPO / "port_bench" / "metrics" / "b3_roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _block_args(side: int) -> list:
    """(in_ch, out_ch, expand_ratio, stride, kernel, H) of the 16 MBConv
    blocks of B0 without stem stride (quadratic stem: 40 channels into
    stage 0) on a side x side image."""
    out, width, size = [], b0_mod.STEM_WIDTH + b0_mod.QUAD_PAIRS, side
    for t, c, n, s, k in b0_mod.B0_STAGES:
        for b in range(n):
            stride = s if b == 0 else 1
            out.append((width, c, t, stride, k, size))
            size = -(-size // stride)
            width = c
    return out


BLOCKS = _block_args(64)


def _randomise(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights and running statistics, so that a swapped mean and
    variance, or a missing norm, cannot pass."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 1.5 + 0.5)
            elif name.endswith("num_batches_tracked"):
                continue
            elif name.endswith("weight") and t.ndim == 1:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                fan_in = t[0].numel() if t.ndim > 1 else 4
                t.copy_(torch.randn(t.shape, generator=g) * fan_in ** -0.5)
    return module


def _block(i: int, norm: str = "batch") -> b0_mod._MBConv:
    in_ch, out_ch, t, s, k, _ = BLOCKS[i]
    return _randomise(b0_mod._MBConv(in_ch, out_ch, t, s, k, norm=norm),
                      seed=i).eval()


def _composition(blk, h):
    """The module's own middle: expand norm and SiLU, the SAME-padded
    depthwise conv, its norm and SiLU; and the spatial sum."""
    if hasattr(blk, "expand_bn"):
        h = F.silu(blk.expand_bn(h))
    y = F.silu(blk.dw_bn(blk.dw_conv(h)))
    return y, y.sum(dim=(2, 3))


@torch.no_grad()
@pytest.mark.parametrize("size", [64, 67])
@pytest.mark.parametrize("index", range(len(BLOCKS)))
def test_plain_matches_the_module_composition(index, size):
    """Every block shape (k 3 and 5, stride 1 and 2, with and without the
    prologue) from an even input and from an odd one, where SAME pads
    stride 2 differently (1 before instead of 0 for k=3)."""
    in_ch, _, t, s, k, H = _block_args(size)[index]
    blk = _block(index)
    g = torch.Generator().manual_seed(100 + index)
    x = torch.randn((2, in_ch, H, H), generator=g)
    h = blk.expand_conv(x) if t != 1 else x
    y, sums = b3.mbconv_dw_plain(
        h, blk.dw_conv.weight, b0_mod._stats(blk.dw_bn, h.dtype),
        b0_mod._stats(blk.expand_bn, h.dtype) if t != 1 else None, s)
    want_y, want_s = _composition(blk, h)
    assert y.shape == want_y.shape == (2, in_ch * t, -(-H // s), -(-H // s))
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sums.numpy(), want_s.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the wrapper takes the plain version for a CPU tensor
    got = b3.mbconv_dw(
        h, blk.dw_conv.weight, b0_mod._stats(blk.dw_bn, h.dtype),
        b0_mod._stats(blk.expand_bn, h.dtype) if t != 1 else None, s)
    assert torch.equal(got[0], y) and torch.equal(got[1], sums)


def test_padded_taps_are_zero_after_the_prologue():
    """The prologue's shift is large, so silu(shift) at a padded tap
    would move every border output: the border matches the composition,
    which pads the activated tensor."""
    blk = _block(1)     # stride 2, k 3, prologue
    with torch.no_grad():
        blk.expand_bn.bias.fill_(3.0)
        h = torch.randn((1, blk.dw_conv.in_channels, 9, 9))
        y, _ = b3.mbconv_dw_plain(h, blk.dw_conv.weight,
                                  b0_mod._stats(blk.dw_bn, h.dtype),
                                  b0_mod._stats(blk.expand_bn, h.dtype), 2)
        want, _ = _composition(blk, h)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size, k, stride", [
    (8, 3, 2), (8, 5, 2), (7, 3, 2), (7, 5, 2), (9, 3, 1), (9, 5, 1),
    (1, 5, 2)])
def test_same_pads_are_models_same_pad(size, k, stride):
    x = torch.zeros((1, 1, size, size))
    want = b0_mod._same_pad(x, k, stride).shape[-1] - size
    assert sum(b3.same_pads(size, k, stride)) == want


def _on_card(training=False, norm="batch", dtype=torch.float32,
             is_cuda=True) -> bool:
    blk = _block(2, norm=norm).train(training)
    return blk.takes_b3(types.SimpleNamespace(dtype=dtype, is_cuda=is_cuda))


@pytest.mark.parametrize("case, want", [
    ({}, True), ({"training": True}, False), ({"norm": "group"}, False),
    ({"dtype": torch.bfloat16}, False), ({"dtype": torch.float64}, False),
    ({"is_cuda": False}, False)])
def test_route_takes_b3_only_in_eval_with_batch_norm_f32_on_cuda(case, want):
    assert _on_card(**case) is want


def _model(norm="batch"):
    model = get_b0(in_channels=2, no_stem_stride=True, quadratic_stem=True,
                   norm=norm)
    return _randomise(model, seed=7).eval()


def _old_forward(model, x):
    """EfficientNetB0.forward with each block's middle as the modules'
    composition, written out: what the CPU forward computed before B3."""
    h = model.conv_stem(x)
    h = torch.cat([h, h[:, :8] * h[:, 8:16]], dim=1)
    h = F.silu(model.bn_stem(h))
    for name, blk in model.named_children():
        if not name.startswith("stage"):
            continue
        inp = h
        if hasattr(blk, "expand_conv"):
            h = F.silu(blk.expand_bn(blk.expand_conv(h)))
        h = F.silu(blk.dw_bn(blk.dw_conv(h)))
        h = blk.project_bn(blk.project_conv(blk.se(h)))
        h = h + inp if blk.residual else h
    h = F.silu(model.bn_head(model.conv_head(h)))
    return model.classifier(h.mean(dim=(2, 3)))


def _counted(fn):
    profiling.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counters = profiling.recorded()["counters"]
    profiling.clear()
    return out, {k: v for k, v in counters.items()
                 if k.startswith("b0.dw_kernel")}


@torch.no_grad()
def test_cpu_eval_forward_is_bit_for_bit_the_composition():
    model = _model()
    x = torch.randn((2, 2, 33, 33), generator=torch.Generator().manual_seed(1))
    got, counts = _counted(lambda: model(x))
    assert torch.equal(got, _old_forward(model, x))
    assert counts == {"b0.dw_kernel.miss": 16}


@torch.no_grad()
def test_the_b3_route_matches_the_composition(monkeypatch):
    """The route a card takes, run here with the plain version in the
    kernel's place: the squeeze-excite from B3's sums / (Ho * Wo), 16 hits
    a forward, logits within the JAX tests' rtol 1e-4 / atol 1e-5."""
    model = _model()
    x = torch.randn((2, 2, 33, 33), generator=torch.Generator().manual_seed(2))
    want = model(x)
    monkeypatch.setattr(
        b0_mod._MBConv, "takes_b3",
        lambda self, h: not self.training and h.dtype == torch.float32)
    got, counts = _counted(lambda: model(x))
    assert counts == {"b0.dw_kernel.hit": 16}
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    # training mode takes the composition, whatever the device
    model.train()
    model.dropout.rate = 0.0
    _, counts = _counted(lambda: model(x))
    assert counts == {"b0.dw_kernel.miss": 16}


def test_gradient_is_the_plain_versions():
    blk = _block(3)
    g = torch.Generator().manual_seed(5)
    h = torch.randn((1, blk.dw_conv.in_channels, 11, 11), generator=g,
                    requires_grad=True)
    w = blk.dw_conv.weight
    dw, ex = (b0_mod._stats(blk.dw_bn, h.dtype),
              b0_mod._stats(blk.expand_bn, h.dtype))
    gy = torch.randn((1, w.shape[0], 6, 6), generator=g)
    gs = torch.randn((1, w.shape[0]), generator=g)
    y, s = b3.mbconv_dw(h, w, dw, ex, 2)
    got = torch.autograd.grad((y, s), (h, w, dw.weight, ex.bias), (gy, gs))
    y, s = b3.mbconv_dw_plain(h, w, dw, ex, 2)
    want = torch.autograd.grad((y, s), (h, w, dw.weight, ex.bias), (gy, gs))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("bad, error", [
    (dict(x=torch.zeros((1, 4, 8, 8), dtype=torch.float64)), TypeError),
    (dict(x=torch.zeros((1, 4, 8, 8)).transpose(2, 3)), ValueError),
    (dict(w=torch.zeros((4, 1, 7, 7))), ValueError),
    (dict(w=torch.zeros((4, 1, 3, 3), dtype=torch.float64)), TypeError),
    (dict(stride=3), ValueError),
    (dict(var=torch.ones(5)), ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    args = dict(x=torch.zeros((1, 4, 8, 8)), w=torch.zeros((4, 1, 3, 3)),
                var=torch.ones(4), stride=1)
    args.update(bad)
    ones = torch.ones(4)
    norm = b3.BatchNormStats(ones, ones, ones, args["var"], 1e-3)
    with pytest.raises(error):
        b3.mbconv_dw(args["x"], args["w"], norm, None, args["stride"])


def test_plan_of_the_benchmark_forward():
    """B=32 at 512^2: tiles of at most 1,024 4-column items within 72 KB of
    ring, a plane's tiles even in size; the 512^2 planes are split into the
    bands of a cluster until a launch has 4,096 blocks, each band two
    tiles or more; blocks of the later planes take 2 to 8 planes, 8 tiles
    or more each."""
    got = [b3._plan(32, t * cin, H, H, k, s)
           for cin, _, t, s, k, H in _block_args(512)]
    assert got[:6] == [(8, 4, 1), (8, 2, 1), (16, 1, 1), (15, 1, 1),
                       (32, 1, 2), (32, 1, 4)]
    assert got[6:] == [(64, 1, 8)] * 5 + [(32, 1, 8)] * 5
    for (cin, _, t, s, k, H), (tr, cl, jobs) in zip(_block_args(512), got):
        Ho = -(-H // s)
        assert b3._ring_bytes(H, k, s, tr) <= b3.SMEM_TARGET
        assert 1 <= tr <= Ho and cl in (1, 2, 4, 8)
        assert cl == 1 or (-(-Ho // cl) >= 2 * tr and jobs == 1)
        assert jobs * -(-Ho // tr) >= b3.MIN_TILES or cl > 1


@pytest.mark.parametrize("W, k, stride, tr, want", [
    # 512 wide, k 3, stride 1: rows of 4 + 512 + 4 floats (the last item's
    # window reads 3 16-byte loads from column 508), 2 tiles of 6 rows
    (512, 3, 1, 4, 4 * 520 * 2 * 6),
    # 37 wide, k 5, stride 2 (2 before): 19 outputs, items at columns 0..16,
    # the last window from column 32 + 0, 4 loads: 48 floats
    (37, 5, 2, 2, 4 * 48 * 2 * 7),
    (1, 3, 1, 1, 4 * 12 * 2 * 3)])
def test_ring_bytes(W, k, stride, tr, want):
    assert b3._ring_bytes(W, k, stride, tr) == want


@pytest.mark.parametrize("side, stride", [(512, True), (64, True),
                                          (67, False), (512, False)])
def test_dw_shapes_are_the_blocks(side, stride):
    """``models.b0.dw_shapes`` (the card tests' and the smoke run's list of
    B3 launches) walks the stages as the model's blocks are built."""
    model = get_b0(in_channels=1, no_stem_stride=stride,
                   quadratic_stem=stride)
    blocks = [m for n, m in model.named_children() if n.startswith("stage")]
    got = b0_mod.dw_shapes(side, stride, stride)
    assert len(got) == len(blocks) == 16
    for (C, _, k, s, prologue), blk in zip(got, blocks):
        assert (C, k, s) == (blk.dw_conv.in_channels,
                             blk.dw_conv.kernel_size[0], blk.dw_conv.stride[0])
        assert prologue == hasattr(blk, "expand_conv")
    if stride:
        assert [H for _, H, *_ in got] == [H for *_, H in _block_args(side)]


def test_reader_counts_the_bytes_of_the_cost():
    """The benchmark's reader walks the configuration's stages to the
    same 16 launches, and the same bytes, as the model's blocks and
    ``mbconv_dw_cost``; 502.9 MiB an image at 512^2."""
    reader = _reader()
    side = 512
    want = sum(b3.mbconv_dw_cost(32, t * cin, H, H, k, s, t != 1)["bytes"]
               for cin, _, t, s, k, H in _block_args(side))
    assert reader.forward_bytes(32, side, B0NS) == want
    assert [(C, H, k, s, p) for C, H, k, s, p in reader.blocks(side, B0NS)] \
        == [(t * cin, H, k, s, t != 1) for cin, _, t, s, k, H in
            _block_args(side)]
    assert abs(reader.forward_bytes(1, side, B0NS) / 2 ** 20 - 502.9) < 0.05


def _run(kernels, trace=True):
    tr = types.SimpleNamespace(kernels=kernels) if trace else None
    return types.SimpleNamespace(
        trace=tr, config=B0NS, traffic={"side": 512, "batch_size": 32},
        peaks={"float32": 67e12, "bytes_per_s": 3.35e12})


def test_reader_reads_whole_forwards_only():
    reader = _reader()
    name = "void (anonymous namespace)::mbconv_dw_kernel<3, 1, 1, false>(" \
        "(anonymous namespace)::Params)"
    other = [("void cudnn::bn_fw_inf_1C11_kernel_NCHW", 1.0)]
    bound = reader.forward_bytes(32, 512, B0NS) / 3.35e12
    got = reader.read(_run([(name, 0.01)] * 32 + other))
    assert got == pytest.approx(100.0 * 2 * bound / 0.32)
    assert reader.read(_run([(name, 0.01)] * 31 + other)) is None
    assert reader.read(_run(other)) is None
    assert reader.read(_run([(name, 0.01)] * 16, trace=False)) is None
