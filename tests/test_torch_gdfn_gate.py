"""Kernel B4's CPU side (``ops.fused_gdfn_gate``): its plain version
against ``models.restormer.FeedForward``'s own composition at each
level's width, its gradient, the route ``FeedForward`` takes, the launch
plan, the zero columns that widths not a multiple of 4 get and the cost.
The kernel itself runs only on the card (tests/test_torch_cuda.py), the
benchmark's readers of B4 in port_bench/tests/test_pb_gated_ffn.py.

The plain version is the composition's own calls (a grouped conv padded
by one, ``chunk``, exact GELU and the product), so on the CPU the two are
equal bit for bit."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from wsunet_tpu_torch.models import restormer
from wsunet_tpu_torch.ops import fused_gdfn_gate as b4
from wsunet_tpu_torch.utils import profiling

# the (h, plane side) of the launches of a restormer_gray forward at 512^2
CELL_SHAPES = list(dict.fromkeys(restormer.gate_shapes(512)))
SMALL = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8), ffn_expansion_factor=2.66)


def _ffn(dim: int, seed: int) -> restormer.FeedForward:
    """A GDFN of ``dim`` channels (hidden int(2.66 dim)) with seeded
    weights, in eval mode."""
    ffn = restormer.FeedForward(dim, 2.66).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in ffn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * p[0].numel() ** -0.5)
    return ffn


def _composition(ffn, u):
    x1, x2 = ffn.dwconv(u).chunk(2, dim=1)
    return torch.nn.functional.gelu(x1) * x2


@torch.no_grad()
@pytest.mark.parametrize("dim, H, W", [
    # the four levels' widths of restormer_gray: 2h = 254, 510, 1020, 2042
    (48, 8, 8), (96, 8, 8), (192, 4, 4), (384, 4, 4),
    # odd and unequal sides
    (48, 7, 9), (96, 5, 3)])
def test_plain_matches_the_module_composition(dim, H, W):
    ffn = _ffn(dim, seed=dim + H)
    x = torch.randn((2, dim, H, W), generator=torch.Generator().manual_seed(H))
    u = ffn.project_in(x)
    assert u.shape[1] == 2 * int(dim * 2.66)
    want = _composition(ffn, u)
    y = b4.gdfn_gate_plain(u, ffn.dwconv.weight)
    assert y.shape == (2, u.shape[1] // 2, H, W)
    assert torch.equal(y, want)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(b4.gdfn_gate(u, ffn.dwconv.weight), y)
    # and the module's forward on the CPU is its old composition
    assert torch.equal(ffn(x), ffn.project_out(want))


def test_gradient_is_the_plain_versions():
    """gradcheck of the wrapper's autograd function (its backward is the
    plain version's VJP) in float64, in u and in w."""
    g = torch.Generator().manual_seed(4)
    u = torch.randn((2, 6, 5, 7), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((6, 1, 3, 3), generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(b4.gdfn_gate, (u, w))
    # one input needing no gradient
    assert torch.autograd.gradcheck(
        lambda t: b4.gdfn_gate(t, w.detach()), (u,))


def _on_card(training=False, dtype=torch.float32, is_cuda=True, width=64):
    ffn = restormer.FeedForward(8, 2.66).train(training)
    return ffn.takes_b4(types.SimpleNamespace(dtype=dtype, is_cuda=is_cuda,
                                              shape=(2, 42, 64, width)))


@pytest.mark.parametrize("case, want", [
    ({}, True), ({"training": True}, False), ({"dtype": torch.float64},
                                              False),
    ({"dtype": torch.bfloat16}, False), ({"is_cuda": False}, False),
    ({"width": 66}, True), ({"width": 63}, True)])
def test_route_takes_b4_only_in_eval_f32_on_cuda(case, want):
    assert _on_card(**case) is want


def _counted(fn):
    profiling.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counters = profiling.recorded()["counters"]
    profiling.clear()
    return out, {k: v for k, v in counters.items()
                 if k.startswith("restormer.gdfn_kernel")}


@torch.no_grad()
def test_cpu_forward_counts_misses_and_the_b4_route_matches(monkeypatch):
    """On the CPU every GDFN takes the composition and counts a miss; the
    route a card takes, run here with the plain version in the kernel's
    place, gives the same output bit for bit and counts a hit each."""
    model = restormer.Restormer(**SMALL).eval()
    restormer.init_restormer(model, seed=3)
    x = torch.rand((2, 1, 16, 24), generator=torch.Generator().manual_seed(5))
    want, counts = _counted(lambda: model(x))
    n = 8   # SMALL's blocks: 3 encoder levels, the latent, 3 decoders, 1
    assert counts == {"restormer.gdfn_kernel.miss": n}
    monkeypatch.setattr(
        restormer.FeedForward, "takes_b4",
        lambda self, u: not self.training and u.dtype == torch.float32)
    got, counts = _counted(lambda: model(x))
    assert counts == {"restormer.gdfn_kernel.hit": n}
    assert torch.equal(got, want)
    model.train()
    _, counts = _counted(lambda: model(x))
    assert counts == {"restormer.gdfn_kernel.miss": n}


@pytest.mark.parametrize("side", [512, 64])
def test_gate_shapes_are_the_blocks(side):
    """``gate_shapes`` (the card tests' and the smoke run's list of B4
    launches) walks the model's FeedForward modules in launch order."""
    with torch.device("meta"):
        model = restormer.Restormer(**restormer.NETWORKS["restormer_gray"])
    got = restormer.gate_shapes(side)
    ffns = [(name, m) for name, m in model.named_modules()
            if isinstance(m, restormer.FeedForward)]
    assert len(got) == len(ffns) == 44
    sides = {"encoder_level1": side, "encoder_level2": side // 2,
             "encoder_level3": side // 4, "latent": side // 8,
             "decoder_level3": side // 4, "decoder_level2": side // 2,
             "decoder_level1": side, "refinement": side}
    for (h, H), (name, m) in zip(got, ffns):
        assert 2 * h == m.dwconv.in_channels and H == sides[name.split(".")[0]]


def _tiles(B, h, H, W):
    """(pair, column tile, band) of each tile index, as the kernel
    decodes it (band fastest)."""
    tw, rows = b4._plan(W)
    nct, nbt = -(-W // tw), -(-H // rows)
    per_pair = nct * nbt
    out = []
    for t in range(B * h * per_pair):
        pr, rem = divmod(t, per_pair)
        c, r = divmod(rem, nbt)
        out.append((pr, c, r))
    return out


def _coverage(H, W):
    """How often the kernel's threads store each output of one plane."""
    tw, rows = b4._plan(W)
    G = tw // 4
    seen = np.zeros((H, W), int)
    for _, c, r in _tiles(1, 1, H, W):
        for tid in range(b4.THREADS):
            g, s = tid % G, tid // G
            if s * b4.RS >= rows:
                continue
            oc, r0 = c * tw + 4 * g, r * rows + s * b4.RS
            if oc < W:
                for i in range(b4.RS):
                    if r0 + i < H:
                        seen[r0 + i, oc:oc + 4] += 1
    return seen


@pytest.mark.parametrize("H, W", [(H, H) for _, H in CELL_SHAPES] +
                         [(72, 40), (40, 72), (9, 8), (5, 4), (20, 136),
                          (33, 260),
                          # 504^2's latent and level 3, padded to 64 and 128
                          (63, 64), (126, 128)])
def test_plan_covers_every_output_once(H, W):
    """Every output of a plane is stored by exactly one thread of one tile;
    the boxes stay within TMA's limits (at most 256 elements a side, rows
    of a multiple of 16 bytes) and two stages of two boxes within 48 KB."""
    tw, rows = b4._plan(W)
    assert tw % 4 == 0 and rows % b4.RS == 0
    assert rows // b4.RS <= min(b4.S_MAX, b4.THREADS // (tw // 4))
    assert tw + 8 <= 256 and rows + 2 <= 256 and 4 * (tw + 8) % 16 == 0
    slot = ((tw + 8) * (rows + 2) + 31) // 32 * 32
    assert 2 * 2 * 4 * slot + 128 <= 48 * 1024
    assert (_coverage(H, W) == 1).all()


def test_tiles_walk_every_pair_once():
    """Tile indices decode to each (pair, column tile, band) once, the
    bands of one plane consecutive; pair b * h + j reads planes
    b * 2h + j and b * 2h + h + j."""
    B, h, H, W = 2, 3, 40, 136
    tiles = _tiles(B, h, H, W)
    tw, rows = b4._plan(W)
    nct, nbt = -(-W // tw), -(-H // rows)
    assert sorted(tiles) == [(p, c, r) for p in range(B * h)
                             for c in range(nct) for r in range(nbt)]
    assert [r for _, _, r in tiles[:nbt]] == list(range(nbt))


def test_plan_of_the_benchmark_forward():
    """512^2 and 256^2 planes: tiles of 128 columns by 16 rows; 128^2 the
    same; 64^2: 64 columns by 32 rows."""
    assert [b4._plan(H) for _, H in CELL_SHAPES] == [
        (128, 16), (128, 16), (128, 16), (64, 32), (128, 16)]


def test_cost_of_a_forward_and_the_readers_bytes():
    """A B=32 forward at 512^2: 44 launches, 384.8 GB (12.03 GB an image;
    port_bench/tests/test_pb_gated_ffn.py holds the benchmark's reader to
    the same bytes)."""
    shapes = restormer.gate_shapes(512)
    total = sum(b4.gdfn_gate_cost(32, h, H, H)["bytes"] for h, H in shapes)
    assert round(total / 1e9, 1) == 384.8


@torch.no_grad()
@pytest.mark.parametrize("W, offset", [
    # every remainder of 4; 504^2's level 3 and latent; a base 4 bytes in
    (1, 0), (2, 0), (3, 0), (5, 0), (126, 0), (63, 0), (8, 1), (7, 1)])
def test_padded_widths_give_the_same_outputs(W, offset):
    """``_padded`` gives what the kernel takes (a width of a multiple of 4
    and a 16-byte aligned base, the input itself where it already is),
    and the middle of the zero-padded u, cropped, is the middle of u: the
    conv pads with zeros on the right anyway.  In float64, since the CPU's
    conv may sum in another order at another width (a few f32 ulps; B4's
    order does not depend on the width)."""
    g = torch.Generator().manual_seed(W)
    flat = torch.randn(offset + 2 * 6 * 5 * W, generator=g,
                       dtype=torch.float64)
    u = flat[offset:].view(2, 6, 5, W)
    w = torch.randn((6, 1, 3, 3), generator=g, dtype=torch.float64)
    p = b4._padded(u)
    assert p.shape == (2, 6, 5, W + (-W % 4)) and p.data_ptr() % 16 == 0
    assert (p is u) == (W % 4 == 0 and u.data_ptr() % 16 == 0)
    assert torch.equal(p[..., :W], u) and not p[..., W:].any()
    torch.testing.assert_close(b4.gdfn_gate_plain(p, w)[..., :W],
                               b4.gdfn_gate_plain(u, w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bad, error", [
    (dict(u=torch.zeros((1, 4, 8, 8), dtype=torch.int32)), TypeError),
    (dict(u=torch.zeros((1, 4, 8, 8), dtype=torch.bfloat16)), TypeError),
    (dict(u=torch.zeros((1, 5, 8, 8)), w=torch.zeros((5, 1, 3, 3))),
     ValueError),
    (dict(u=torch.zeros((4, 8, 8))), ValueError),
    (dict(u=torch.zeros((1, 4, 8, 8)).transpose(2, 3)), ValueError),
    (dict(w=torch.zeros((4, 1, 5, 5))), ValueError),
    (dict(w=torch.zeros((4, 1, 3, 3), dtype=torch.float64)), TypeError)])
def test_wrapper_rejects_what_neither_version_takes(bad, error):
    args = dict(u=torch.zeros((1, 4, 8, 8)), w=torch.zeros((4, 1, 3, 3)))
    args.update(bad)
    with pytest.raises(error), torch.no_grad():
        b4.gdfn_gate(args["u"], args["w"])
