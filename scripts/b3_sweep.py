#!/usr/bin/env python3
"""Sweep kernel B3's launch plan and build constants on one NVIDIA card.

    python3 scripts/b3_sweep.py [SETTING ...]   # from the repository root

B3 (``wsunet_tpu_torch/ops/fused_mbconv_dw.py``, ``csrc/mbconv_dw.cu``)
takes its plan -- output rows a tile, blocks a plane, planes a block --
from ``_plan`` at run time, and its threads, ring depth and register
bound from the source.  Each entry of ``PLANS`` launches the committed
library with the plan ``_plan`` gives under other targets; each entry of
``BUILDS`` builds an edited copy of the source (into ``build/b3_sweep/``,
all nvcc runs started together) and launches it with the committed plan.
Every setting but the diagnostics (``DIAGNOSTIC``: wrong results on
purpose, to show what a part of the kernel costs) is held against B3's
plain version at each block, then timed by CUDA-graph replay at each of
the 16 depthwise stages of B0 without stem stride at 512x512, B=32,
beside the committed kernel.  It prints the card, one JSON line per
setting (ms a block and in all), and needs a card and nvcc; it imports
no JAX.  With SETTING arguments it runs those settings alone.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from wsunet_tpu_torch.models.b0 import dw_shapes  # noqa: E402
from wsunet_tpu_torch.ops import _cuda_build  # noqa: E402
from wsunet_tpu_torch.ops import fused_mbconv_dw as b3  # noqa: E402

OUT = ROOT / "build" / "b3_sweep"
BATCH = 32
# setting -> targets of _plan set on the module while it plans
PLANS = {"ITEMS=512": {"ITEMS": 512}, "ITEMS=2048": {"ITEMS": 2048},
         "SMEM_TARGET=48K": {"SMEM_TARGET": 48 * 1024},
         "SMEM_TARGET=100K": {"SMEM_TARGET": 100 * 1024},
         "MIN_TILES=4": {"MIN_TILES": 4}, "MIN_TILES=16": {"MIN_TILES": 16},
         "MIN_BLOCKS=16384": {"MIN_BLOCKS": 16384}}
# setting -> {text in the source: its replacement}; a setting also in
# BUILD_PLANS launches with the plan of those targets
BOUNDS = "__global__ void __launch_bounds__(THREADS, 4)"
DEPTH = "constexpr int DEPTH = 1;"
# the wait for tile t + 1 and its prologue before tile t is computed
WAIT = ("    cp_async_wait<DEPTH - 1>();  // tile t + 1 has landed\n"
        "    transform(t + 1);\n")
COPIES = "    issue(t + DEPTH);\n"
EARLY = {WAIT: "", COPIES: COPIES + WAIT}
BUILDS = {
    "bounds(256,3)": {BOUNDS: "__global__ void __launch_bounds__(THREADS, 3)"},
    "bounds(256,5)": {BOUNDS: "__global__ void __launch_bounds__(THREADS, 5)"},
    "bounds(256,6)": {BOUNDS: "__global__ void __launch_bounds__(THREADS, 6)"},
    "DEPTH=2": {DEPTH: "constexpr int DEPTH = 2;"},
    "DEPTH=2 early wait": {DEPTH: "constexpr int DEPTH = 2;", **EARLY},
    "DEPTH=2 early wait planned": {DEPTH: "constexpr int DEPTH = 2;",
                                   **EARLY},
    # diagnostics, wrong results: SiLU as the identity; SiLU with the fast
    # exp and division (what the IEEE division and expf cost); the
    # prologue left out; the taps left out (window reads and FMAs)
    "no silu": {"  return v / (1.0f + expf(-v));": "  return v;"},
    "fast silu": {"  return v / (1.0f + expf(-v));":
                  "  return __fdividef(v, 1.0f + __expf(-v));"},
    "no prologue": {"    if (!PRO || t >= total) return;":
                    "    if (PRO || t >= total) return;"},
    "no taps": {"      for (int kh = 0; kh < K; ++kh) {":
                "      for (int kh = 0; kh < 0; ++kh) {"}}
BUILD_PLANS = {"DEPTH=2 early wait planned": {"DEPTH": 2}}
DIAGNOSTIC = ("no silu", "fast silu", "no prologue", "no taps")


def build_all(names) -> dict:
    """The library of each build setting in ``names``, built in parallel."""
    src = (_cuda_build.CSRC / "mbconv_dw.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        text = src
        for old, new in BUILDS[name].items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        tag = "".join(c if c.isalnum() else "_" for c in name)
        cu = OUT / f"mbconv_dw_{tag}.cu"
        cu.write_text(text)
        so = OUT / f"libmbconv_dw_{tag}.so"
        cmd = [_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS, "-o",
               str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def launcher(lib, plan, w, dw, ex, stride):
    """fn(x) -> (y, s) through ``lib``'s C entry point with ``plan``."""
    fn = lib.mbconv_dw_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + \
        [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k = w.shape[-1]

    def run(x):
        B, C, H, W = x.shape
        Ho, Wo = -(-H // stride), -(-W // stride)
        y = torch.empty((B, C, Ho, Wo), device=x.device)
        s = torch.empty((B, C), device=x.device)
        exp = [None] * 4 if ex is None else [t.data_ptr() for t in ex[:4]]
        err = fn(x.data_ptr(), w.data_ptr(), *exp,
                 0.0 if ex is None else ex.eps,
                 *[t.data_ptr() for t in dw[:4]], dw.eps, y.data_ptr(),
                 s.data_ptr(), B, C, H, W, k, stride, *plan,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y, s

    return run


def planned(targets: dict, *shape) -> tuple:
    saved = {k: getattr(b3, k) for k in targets}
    try:
        for k, v in targets.items():
            setattr(b3, k, v)
        return b3._plan(*shape)
    finally:
        for k, v in saved.items():
            setattr(b3, k, v)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("b3_sweep: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chosen = argv or [*PLANS, *BUILDS]
    committed = _cuda_build.load_all(_cuda_build.SOURCES)[b3.SOURCE]
    libs = build_all([n for n in chosen if n in BUILDS])
    times = {name: [] for name in ["committed", *chosen]}
    with torch.no_grad():
        for i, (C, H, k, stride, pro) in enumerate(
                dw_shapes(512, no_stem_stride=True, quadratic_stem=True)):
            g = torch.Generator(device="cuda").manual_seed(300 + i)

            def norm():
                return b3.BatchNormStats(
                    torch.rand(C, device="cuda", generator=g) + 0.5,
                    torch.randn(C, device="cuda", generator=g),
                    torch.randn(C, device="cuda", generator=g),
                    torch.rand(C, device="cuda", generator=g) * 1.5 + 0.5,
                    1e-3)

            x = 2.0 * torch.randn((BATCH, C, H, H), device="cuda",
                                  generator=g)
            w = torch.randn((C, 1, k, k), device="cuda", generator=g) / k
            dw, ex = norm(), (norm() if pro else None)
            want_y, want_s = b3.mbconv_dw_plain(x, w, dw, ex, stride)
            shape = (BATCH, C, H, H, k, stride)
            runs = {"committed": launcher(committed, b3._plan(*shape), w,
                                          dw, ex, stride)}
            for name in chosen:
                plan = planned({**PLANS.get(name, {}),
                                **BUILD_PLANS.get(name, {})}, *shape)
                runs[name] = launcher(libs.get(name, committed), plan, w,
                                      dw, ex, stride)
            for name, run in runs.items():
                if name not in DIAGNOSTIC:
                    y, s = run(x)
                    torch.cuda.synchronize()
                    ok = bool(((y - want_y).abs() <=
                               1e-5 * want_y.abs() + 1e-5).all()) and \
                        bool(((s - want_s).abs() <= 6.2e-5 * want_y.abs().sum(
                            dim=(2, 3)) + 1e-5).all())
                    if not ok:
                        raise RuntimeError(f"{name}, block {i}: not within "
                                           "the plain version's tolerance")
                    del y, s
                times[name].append(chip_smoke.graph_ms(run, [x], reps=3,
                                                       iters=5))
            del x, want_y, want_s
    bound = sum(1e3 * b3.mbconv_dw_cost(BATCH, C, H, H, k, s, p)["bytes"] /
                chip_smoke.HBM_BYTES_PER_S for C, H, k, s, p in
                dw_shapes(512, no_stem_stride=True, quadratic_stem=True))
    for name, ms in times.items():
        print(json.dumps({"setting": name, "ms": sum(ms),
                          "roofline": bound / sum(ms),
                          "blocks_ms": [round(t, 4) for t in ms]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
