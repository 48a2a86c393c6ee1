"""Kernel B2, the fused WS attack (wsunet_tpu_torch.ops.fused_ws).

On the CPU: its plain version against the Pallas kernel
(``wsunet_tpu.ops.pallas_ws.ws_attack_fused``, interpret mode) and
against the reference formula (``wsunet_tpu.ops.ws_attack``), for every
filter and weighting, at 64x64 and ragged sizes; and the wrapper's
dispatch and checks; the launch plan ``_plan``; and that the CUDA source
exports what the wrapper binds.  The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance rtol 1e-4 / atol 1e-6, that of tests/test_pallas_ws.py: the f32
sums are taken in another order (and ws_attack scales by 1/255 and back).
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wsunet_tpu.ops import NAMED_FILTERS_2D, ws_attack
from wsunet_tpu.ops.pallas_ws import ws_attack_fused as jax_fused
from wsunet_tpu_torch.ops import _cuda_build, fused_ws

REPO = pathlib.Path(__file__).resolve().parents[1]

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


@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("H", [3, 4, 5, 17, 37, 130, 512, 513])
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_covers_every_interior_row_once(B, H, max_cluster):
    """Every interior row 1..H-2 lies in exactly one block's run, no block
    is empty, the cluster is one the launch takes, and the bands fit."""
    W = 512
    cl, rpb, R = fused_ws._plan(B, H, W, max_cluster)
    assert 1 <= cl <= min(max_cluster, fused_ws.CLUSTER_WIDE)
    owners = np.zeros(H, int)
    for rank in range(cl):
        r0 = 1 + rank * rpb
        r1 = min(H - 1, r0 + rpb)   # as the kernel computes them
        assert r1 > r0, (rank, r0, r1)
        owners[r0:r1] += 1
    assert owners[0] == 0 and owners[-1] == 0
    assert np.all(owners[1:-1] == 1)
    assert 1 <= R <= min(rpb, fused_ws.BAND_ROWS)
    ring = fused_ws.STAGES * fused_ws._stage_bytes(W, R) + 16
    assert ring <= fused_ws.SMEM_MAX


def test_plan_takes_wide_clusters_where_the_card_does():
    assert fused_ws._plan(8, 512, 512) == (16, 32, 16)
    assert fused_ws._plan(128, 512, 512) == (16, 32, 16)
    assert fused_ws._plan(128, 512, 512, max_cluster=8) == (8, 64, 16)


@pytest.mark.parametrize("W", [3, 15, 16, 17, 130, 257, 4096, 20000])
def test_plan_bands_fit_shared_memory(W):
    cl, rpb, R = fused_ws._plan(4, 300, W)
    assert R >= 1
    assert fused_ws.STAGES * fused_ws._stage_bytes(W, R) + 16 <= \
        fused_ws.SMEM_MAX
    assert fused_ws._stage_bytes(W, R) % 128 == 0
    assert fused_ws._stage_bytes(W, R) >= (R + 2) * W + 32


def test_plan_rejects_an_image_too_wide():
    with pytest.raises(ValueError, match="width"):
        fused_ws._plan(1, 10, 60000)


def test_cpu_path_needs_no_build_triton_or_nvcc():
    """The module imports and runs its CPU path with no nvcc on PATH and
    without loading _cuda_build or triton."""
    code = (
        "import sys, torch\n"
        "from wsunet_tpu_torch.ops import fused_ws\n"
        "x = torch.arange(2 * 9 * 11, dtype=torch.int64).reshape(2, 9, 11)\n"
        "x = (x * 37 % 256).to(torch.uint8)\n"
        "b = fused_ws.ws_attack_fused(x, 'KB', 1)\n"
        "assert b.shape == (2,) and bool(torch.isfinite(b).all())\n"
        "assert fused_ws.launches == 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'triton'"
        " or m.endswith('_cuda_build')))\n")
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_cuda_source_exports_what_the_wrapper_binds():
    """No nvcc here: ws_fused.cu is one of the sources built together, has
    the C entry points the wrapper binds, no PyTorch header, and the
    wrapper's launch constants."""
    assert fused_ws.SOURCE in _cuda_build.SOURCES
    assert len(set(_cuda_build.SOURCES)) == len(_cuda_build.SOURCES)
    text = (REPO / "wsunet_tpu_torch" / "csrc" /
            f"{fused_ws.SOURCE}.cu").read_text()
    c_block = text.split('extern "C" {', 1)[1]
    assert set(re.findall(r"^(?:int|const char\*) (\w+)\(", c_block,
                          re.M)) == {"ws_fused_launch",
                                     "ws_fused_max_cluster",
                                     "ws_fused_recip",
                                     "ws_fused_error_string"}
    assert not re.search(r"#include\s*[<\"](torch|ATen|c10)", text)
    assert f"constexpr int STAGES = {fused_ws.STAGES};" in text
    assert f"constexpr int SMEM_MAX = {fused_ws.SMEM_MAX // 1024} * 1024;" \
        in text
    assert set(fused_ws._FILTER_ID) == set(NAMED_FILTERS_2D)
    assert sorted(fused_ws._FILTER_ID.values()) == [0, 1, 2, 3]
    assert "enum { KB = 0, AVG = 1, AVG9 = 2, ONE = 3 };" in text


def _script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sweep_edits_match_the_source():
    """scripts/b2_sweep.py builds edited copies of csrc/ws_fused.cu: every
    text it replaces is in the source, and its plans cover every row."""
    sweep = _script("b2_sweep")
    text = (REPO / "wsunet_tpu_torch" / "csrc" / "ws_fused.cu").read_text()
    for name, subs in sweep.BUILDS.items():
        for old in subs:
            assert old in text, (name, old)
    for cl, rpb, R in sweep.PLANS.values():
        assert (cl - 1) * rpb < sweep.S - 2 <= cl * rpb and R >= 1


@pytest.mark.parametrize("line, op", [
    ("        /*0010*/              @!P0 LDG.E.U8.CONSTANT R2, "
     "desc[UR4][R2.64] ;     /* 0x000 */", "LDG.E.U8.CONSTANT"),
    ("        /*0020*/               @P1 I2FP.F32.U32 R3, R2 ;",
     "I2FP.F32.U32"),
    ("        /*0a30*/                   PRMT R29, R26, 0x7441, R3 ;", "PRMT"),
    ("        /*1f40*/              @!UP1 SYNCS.EXCH.64 URZ, [UR10], UR8 ;",
     "SYNCS.EXCH.64")])
def test_sass_counts_reads_each_opcode(line, op):
    sass = _script("sass_counts")
    text = f"\tcode for sm_90a\n\t\tFunction : _Z1kv\n{line}\n"
    assert [i[1] for i in sass.listing(text)["_Z1kv"]] == [op]


def test_sass_counts_finds_innermost_loops():
    sass = _script("sass_counts")
    text = ("\t\tFunction : _Z1kv\n"
            "        /*0000*/                   MOV R1, R2 ;\n"
            "        /*0010*/                   FADD R1, R1, R2 ;\n"
            "        /*0020*/                   FADD R1, R1, R2 ;\n"
            "        /*0030*/               @P0 BRA 0x10 ;\n"
            "        /*0040*/               @P1 BRA 0x0 ;\n"
            "        /*0050*/                   EXIT ;\n")
    ins = sass.listing(text)["_Z1kv"]
    assert [(at, n, dict(mix)) for at, n, mix in sass.loops(ins)] == [
        (0x10, 3, {"FADD": 2, "BRA": 1})]
