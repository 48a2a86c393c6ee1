#!/usr/bin/env python3
"""Sweep kernel B2's launch plan and ring depth on one NVIDIA card.

    python3 scripts/b2_sweep.py        # from the root of the repository

B2 (``wsunet_tpu_torch/ops/fused_ws.py``, ``csrc/ws_fused.cu``) takes its
plan -- blocks an image (CL), rows a block, rows a band (R) -- from
``_plan`` at run time, and its ring depth from ``STAGES`` in the source.
Each entry of ``PLANS`` launches the committed library's C entry point
with another plan; each entry of ``BUILDS`` builds an edited copy of the
source (into ``build/b2_sweep/``, all nvcc runs started together) and
launches it with the committed plan.  Every setting but the two
diagnostics (``DIAGNOSTIC``: the kernel without its copies, and without
its compute) is held against B2's plain version, then timed by CUDA-graph
replay at B=128, 512x512 (inputs rotating over 4 x 33.5 MB, as
``chip_smoke.py`` phase 7) for a few filters and weightings, between two
timings of the committed kernel and plan.  It prints the card, one JSON
line per setting, and the SM clock and power sampled while the committed
kernel runs.  It needs a card and nvcc, and imports no JAX.
"""

import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from wsunet_tpu_torch.ops import _cuda_build, fused_ws  # noqa: E402

OUT = ROOT / "build" / "b2_sweep"
B, S = 128, 512
CASES = [("KB", 0), ("KB", 1), ("1", 0), ("AVG9", 0)]
# setting -> (CL, rows a block, rows a band) at B=128, 512x512
PLANS = {"CL=8 R=16": (8, 64, 16), "CL=7 R=16": (7, 73, 16),
         "CL=12 R=16": (12, 43, 16), "CL=16 R=4": (16, 32, 4),
         "CL=16 R=8": (16, 32, 8), "CL=16 R=32": (16, 32, 32)}
# setting -> {text in the source: its replacement}
BUILDS = {
    "STAGES=2": {"constexpr int STAGES = 3;": "constexpr int STAGES = 2;"},
    "STAGES=4": {"constexpr int STAGES = 3;": "constexpr int STAGES = 4;"},
    # diagnostics, wrong results: the walk without the bulk copies (on
    # stale shared memory), and the copies without the walk
    "no copy (compute alone)": {
        "      mbar_arrive_tx(bar, bytes);\n": "      mbar_arrive(bar);\n",
        "      asm volatile(\n          \"cp.async.bulk":
        "      if (bytes == 0) asm volatile(\n          \"cp.async.bulk"},
    "no walk (copies alone)": {
        "      if (nv == CPT)\n": "      if (nv == -1)\n",
        "      else\n        walk<F, WT, false>":
        "      else if (nv == -2)\n        walk<F, WT, false>"}}
DIAGNOSTIC = ("no copy (compute alone)", "no walk (copies alone)")


def build_all() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_cuda_build.CSRC / f"{fused_ws.SOURCE}.cu").read_text()
    procs = {}
    for name, subs in BUILDS.items():
        src = text
        for old, new in subs.items():
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            src = src.replace(old, new)
        stem = OUT / "".join(c if c.isalnum() else "_" for c in name)
        stem.with_suffix(".cu").write_text(src)
        procs[name] = (stem, subprocess.Popen(
            [_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS, "-o",
             str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = fused_ws._bind_types(ctypes.CDLL(str(stem.with_suffix(
            ".so"))))
    return libs


def launcher(lib, plan, kname, w):
    def run(x):
        out = torch.empty((B,), dtype=torch.float32, device=x.device)
        err = lib.ws_fused_launch(
            x.data_ptr(), out.data_ptr(), B, S, S, fused_ws._FILTER_ID[kname],
            w, *plan, 1.0 / ((S - 2) * (S - 2)),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("b2_sweep: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    base = fused_ws._bind_types(
        _cuda_build.load_all(_cuda_build.SOURCES)[fused_ws.SOURCE])
    committed = fused_ws._plan(B, S, S)
    settings = {name: (base, plan) for name, plan in PLANS.items()}
    settings.update({name: (lib, committed)
                     for name, lib in build_all().items()})
    g = torch.Generator(device="cuda").manual_seed(0)
    bufs = [torch.randint(0, 256, (B, S, S), dtype=torch.uint8,
                          device="cuda", generator=g) for _ in range(4)]
    for name, (lib, plan) in settings.items():
        row = {"setting": name, "plan": plan}
        for kname, w in CASES:
            fn = launcher(lib, plan, kname, w)
            ref = launcher(base, committed, kname, w)
            want = fused_ws.ws_attack_fused_plain(bufs[0], kname, w)
            if name not in DIAGNOSTIC and not torch.allclose(
                    fn(bufs[0]), want, rtol=1e-4, atol=1e-6):
                raise RuntimeError(f"{name} {kname} w={w}: != plain")
            t0 = chip_smoke.graph_ms(ref, bufs)
            ms = chip_smoke.graph_ms(fn, bufs)
            t1 = chip_smoke.graph_ms(ref, bufs)
            row[f"{kname} w={w}"] = {"ms": ms, "committed_ms": [t0, t1]}
        print(json.dumps(row))
    print(f"committed plan {committed}, STAGES = {fused_ws.STAGES}; device "
          "ms a call by CUDA-graph replay, B=128, 512x512")
    print("clocks under load: " + json.dumps(clocks_under_load(
        launcher(base, committed, "KB", 0), bufs)))
    return 0


def clocks_under_load(fn, bufs, seconds: float = 2.0) -> list:
    """nvidia-smi's SM clock, its maximum and the power draw, sampled every
    200 ms while ``fn`` runs back to back (CUDA-graph replay) for about
    ``seconds``."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(bufs[0])
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for i in range(100):
            fn(bufs[i % len(bufs)])
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()
    smi.terminate()
    return [ln.strip() for ln in smi.communicate()[0].splitlines()
            if ln.strip()]


if __name__ == "__main__":
    sys.exit(main())
