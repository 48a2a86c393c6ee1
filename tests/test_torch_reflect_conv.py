"""Port parity of the reflect-padded 3x3 convs, on the CPU, f32:

- B1's plain version (``ops.fused_reflect_conv``) against the Pallas
  kernel's ``_reference`` and against the kernel itself in interpret mode,
  at the shapes ``tests/test_pallas_conv.py`` uses, rtol/atol 1e-5 (as
  that file states: f32 sums in another order);
- the port's ``conv3x3_reflect_borderfix`` against JAX's (rtol 1e-5,
  atol 2e-5, as ``tests/test_reflect_conv.py``);
- gradients (x, w, b) through the port's autograd Function against
  ``jax.grad`` of ``conv3x3_reflect_fused`` (1e-4);
- the U-Net with ``fast_conv`` in {False, "borderfix", True} against the
  Flax U-Net with the same ``fast_conv`` on random weights (atol 1e-5, as
  ``tests/test_torch_unet.py``);
- the wrapper's checks, its choice of CUDA variant (``_variant``) and its
  launch counts, and the nvcc build's errors and parallel builds (no nvcc
  here).

Inputs come from seeded numpy and go to both packages.  On the CPU the
port's wrapper takes the plain version; the CUDA kernel itself is held
against it in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsunet_tpu.experiments.pallas_reflect_conv import (
    _TH, _forward, _reference)
from wsunet_tpu.experiments.pallas_reflect_conv import (
    conv3x3_reflect_fused as jax_fused)
from wsunet_tpu.models import get_model as jax_get_model
from wsunet_tpu.ops.reflect_conv import (
    conv3x3_reflect_borderfix as jax_borderfix)
from wsunet_tpu_torch.models import get_model, unet_state_dict_from_flax
from wsunet_tpu_torch.ops import _cuda_build, fused_reflect_conv
from wsunet_tpu_torch.ops.fused_reflect_conv import (
    conv3x3_reflect_fused, conv3x3_reflect_fused_plain)
from wsunet_tpu_torch.ops.reflect_conv import conv3x3_reflect_borderfix

REPO = pathlib.Path(__file__).resolve().parents[1]


def _xwb(shape, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(3, 3, shape[-1], cout)).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the shapes of tests/test_pallas_conv.py (interpret mode needs H % 8 == 0)
PALLAS_SHAPES = [((2, 32, 40, 3), 8), ((1, 48, 16, 1), 4),
                 ((1, 4 * _TH, 24, 2), 4), ((2, 32, 24, 3), 8)]


@pytest.mark.parametrize("shape, cout", PALLAS_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_reference_and_interpret_kernel(shape, cout, relu):
    x, w, b = _xwb(shape, cout, seed=0)
    got = conv3x3_reflect_fused(*_t(x, w, b), relu=relu)
    assert got.shape == shape[:3] + (cout,) and got.is_contiguous()
    ref = np.asarray(_reference(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), relu=relu))
    kern = np.asarray(_forward(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), relu=relu, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape, cout", [
    ((2, 16, 16, 3), 5), ((1, 32, 24, 1), 8), ((2, 8, 40, 4), 4),
    ((3, 37, 29, 5), 7), ((1, 2, 2, 1), 3), ((2, 9, 130, 6), 4)])
@pytest.mark.parametrize("relu", [False, True])
def test_borderfix_matches_jax(shape, cout, relu):
    x, w, b = _xwb(shape, cout, seed=1)
    got = conv3x3_reflect_borderfix(*_t(x, w, b), relu=relu)
    want = np.asarray(jax_borderfix(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), relu=relu))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    # and the plain B1 (the reflect pad it replaces) at ragged shapes
    plain = conv3x3_reflect_fused_plain(*_t(x, w, b), relu=relu)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_gradients_match_jax(relu):
    x, w, b = _xwb((2, 8, 8, 2), 3, seed=2)
    g = np.random.default_rng(3).normal(size=(2, 8, 8, 3)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_fused(*a, relu=relu) *
                                       jnp.asarray(g)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (t.requires_grad_() for t in _t(x, w, b))
    (conv3x3_reflect_fused(xt, wt, bt, relu=relu) *
     torch.from_numpy(g)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


def test_gradient_only_where_asked():
    x, w, b = _t(*_xwb((1, 6, 5, 2), 3, seed=4))
    x.requires_grad_()
    (gx,) = torch.autograd.grad(conv3x3_reflect_fused(x, w, b).sum(), x)
    assert gx.shape == x.shape and w.grad is None and b.grad is None


def _flax_params(nsteps, disable_center, size, seed=3):
    model = jax_get_model(f"unet_{nsteps}", disable_center=disable_center)
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, size, size, 1), jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
        .astype(np.float32), v["params"])


@pytest.mark.parametrize("fast_conv", [False, "borderfix", True])
@pytest.mark.parametrize("nsteps, size, disable_center", [
    (1, 32, False), (2, 64, True), (2, 48, False)])
def test_unet_fast_conv_matches_jax(fast_conv, nsteps, size, disable_center):
    params = _flax_params(nsteps, disable_center, size)
    x = np.random.default_rng(5).random((2, size, size, 1), dtype=np.float32)
    jmodel = jax_get_model(f"unet_{nsteps}", disable_center=disable_center,
                           fast_conv=fast_conv)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    tmodel = get_model(f"unet_{nsteps}", disable_center=disable_center,
                       fast_conv=fast_conv)
    tmodel.load_state_dict(unet_state_dict_from_flax(params))
    fused_reflect_conv.reset_launches()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x[..., 0])[:, None])
    # the CPU takes the plain version
    assert fused_reflect_conv.launches == 0
    assert not any(fused_reflect_conv.launches_by_variant.values())
    np.testing.assert_allclose(got[:, 0].numpy(), want[..., 0], atol=1e-5,
                               rtol=0)


def test_unet_rejects_unknown_fast_conv():
    with pytest.raises(ValueError):
        get_model("unet_1", fast_conv="pallas")
    with pytest.raises(ValueError):
        get_model("unet_1", fast_conv=1)


@pytest.mark.parametrize("make, err", [
    (lambda x, w, b: (x.double(), w.double(), b.double()), TypeError),
    (lambda x, w, b: (x.half(), w.half(), b.half()), TypeError),
    (lambda x, w, b: (x, w.bfloat16(), b), TypeError),
    (lambda x, w, b: (x[:, :1], w, b), ValueError),          # H < 2
    (lambda x, w, b: (x[:, :, :1], w, b), ValueError),       # W < 2
    (lambda x, w, b: (x[0], w, b), ValueError),              # not 4-D
    (lambda x, w, b: (x[..., :1], w, b), ValueError),        # C != w's
    (lambda x, w, b: (x, w, b[:2]), ValueError),
    (lambda x, w, b: (x.transpose(1, 2), w, b), ValueError),  # not NHWC
    (lambda x, w, b: (x, w.to("meta"), b), ValueError),      # two devices
    (lambda x, w, b: (x.to("meta"), w.to("meta"), b.to("meta")),
     ValueError),                                            # no kernel
])
def test_wrapper_rejects(make, err):
    x, w, b = _t(*_xwb((2, 6, 6, 3), 4, seed=6))
    with pytest.raises(err):
        conv3x3_reflect_fused(*make(x, w, b))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.find_nvcc()


def test_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    """A failed build raises with nvcc's output and leaves no library."""
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _cuda_build.load_all(["reflect_conv3x3"])
    assert not list((tmp_path / "kernels").iterdir())


def test_library_name_hashes_source_and_flags(monkeypatch):
    a = _cuda_build.library_path("reflect_conv3x3")
    assert a.parent == _cuda_build.BUILD_DIR
    assert re.fullmatch(r"libreflect_conv3x3_[0-9a-f]{16}\.so", a.name)
    monkeypatch.setattr(_cuda_build, "NVCC_FLAGS",
                        _cuda_build.NVCC_FLAGS + ["-DX"])
    assert _cuda_build.library_path("reflect_conv3x3") != a
    flags = " ".join(_cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def test_cuda_source_exports_what_the_wrapper_binds():
    """No nvcc here: check each source's C entry points by name, that each
    entry point the wrapper binds lies in the source it loads it from, and
    that no source includes a PyTorch header."""
    exported = {}
    for src in fused_reflect_conv.SOURCES:
        text = (REPO / "wsunet_tpu_torch" / "csrc" / f"{src}.cu").read_text()
        c_block = text.split('extern "C" {', 1)[1]
        exported[src] = set(re.findall(r"^(?:int|const char\*) (\w+)\(",
                                       c_block, re.M))
        assert not re.search(r"#include\s*[<\"](torch|ATen|c10)", text)
    want = {src: set() for src in fused_reflect_conv.SOURCES}
    for src, entry in fused_reflect_conv._ENTRY.values():
        want[src].add(entry)
    want["reflect_conv3x3"].add("reflect_conv3x3_error_string")
    assert exported == want
    assert set(fused_reflect_conv.SOURCES) == {"reflect_conv3x3",
                                               "reflect_conv3x3_wgmma"}
    # every (variant, dtype) that _variant can name has an entry point
    named = {(fused_reflect_conv._variant(C, dt), dt)
             for C in range(1, 80) for dt in (torch.float32, torch.bfloat16)}
    assert named == set(fused_reflect_conv._ENTRY)


@pytest.mark.parametrize("C, bf16, f32", [
    (1, "direct", "direct"), (8, "direct", "direct"), (9, "direct", "direct"),
    (15, "direct", "direct"), (16, "wgmma", "fma"), (24, "wgmma", "fma"),
    (64, "wgmma", "fma"), (130, "direct", "fma"), (256, "wgmma", "fma")])
def test_variant_by_channels_and_dtype(C, bf16, f32):
    """wgmma: bf16 with C % 8 == 0 and C >= 16; fma: f32 with C >= 16;
    direct: the rest."""
    assert fused_reflect_conv._variant(C, torch.bfloat16) == bf16
    assert fused_reflect_conv._variant(C, torch.float32) == f32


def test_unet2_layers_take_nine_wide_and_one_direct():
    """unet_2's 10 convs: e1.conv1 (C=1) is direct, the 9 others wgmma in
    bf16 and fma in f32."""
    cin = [1, 64, 64, 128, 128, 256, 256, 128, 128, 64]
    for dtype, wide in ((torch.bfloat16, "wgmma"), (torch.float32, "fma")):
        got = [fused_reflect_conv._variant(C, dtype) for C in cin]
        assert got == ["direct"] + [wide] * 9


def test_reset_launches_clears_every_count(monkeypatch):
    monkeypatch.setattr(fused_reflect_conv, "launches", 7)
    monkeypatch.setitem(fused_reflect_conv.launches_by_variant, "wgmma", 5)
    monkeypatch.setitem(fused_reflect_conv.launches_by_variant, "direct", 2)
    fused_reflect_conv.reset_launches()
    assert fused_reflect_conv.launches == 0
    assert fused_reflect_conv.launches_by_variant == {
        "wgmma": 0, "direct": 0, "fma": 0}


def test_builds_start_together(tmp_path, monkeypatch):
    """load_all starts one nvcc a source, all before the first ends, and
    raises with every failed build's output."""
    (tmp_path / "bin").mkdir()
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho start >> {log}\nsleep 1\n"
                    f"echo end >> {log}\necho 'error: no card' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError) as err:
        _cuda_build.load_all(fused_reflect_conv.SOURCES)
    for src in fused_reflect_conv.SOURCES:
        assert f"failed to build {src} " in str(err.value)
    assert log.read_text().split() == ["start", "start", "end", "end"]
    assert not list((tmp_path / "kernels").iterdir())


def test_fast_conv_entry_points_need_a_card():
    """device=None means CUDA: without a card the fast-conv entry points
    raise rather than run B1's plain version on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    from wsunet_tpu_torch.serve import UNetWSServer
    from wsunet_tpu_torch.utils.errors import UserError
    from wsunet_tpu_torch.ws import predict_batch

    model = get_model("unet_1", fast_conv=True)
    with pytest.raises(UserError, match="device='cpu'"):
        predict_batch(model, np.zeros((1, 32, 32), np.uint8))
    with pytest.raises(UserError):
        UNetWSServer(model, size=32)
    # on the CPU, asked for, the same model serves through the plain version
    srv = UNetWSServer(model, size=32, device="cpu")
    assert np.all(np.isfinite(srv.predict(np.zeros((32, 32), np.uint8))))
