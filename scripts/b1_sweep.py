#!/usr/bin/env python3
"""Sweep kernel B1's compile-time tile constants on one NVIDIA card.

    python3 scripts/b1_sweep.py        # from the root of the repository

B1 (``wsunet_tpu_torch/ops/fused_reflect_conv.py``) takes its tile shapes
from constants in its two CUDA sources.  Each entry of ``SWEEP`` names a
variant and replaces some constants in that variant's source.  The script
builds every entry with the port's nvcc flags into ``build/b1_sweep/``
(all builds started together), holds each against B1's plain version at a
few edge shapes, then times it at the ``unet_2`` layer shapes its variant
serves (B=32, 512x512, ReLU on) by CUDA events, between two timings of the
committed kernel.  It prints the card, one JSON line per layer and the
totals per setting.  It needs a card and nvcc, and imports no JAX.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from wsunet_tpu_torch._device import disable_tf32  # noqa: E402
from wsunet_tpu_torch.ops import _cuda_build  # noqa: E402
from wsunet_tpu_torch.ops import fused_reflect_conv as frc  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "b1_sweep"
# setting -> (the variant it changes, {text in the variant's source: its
# replacement})
SWEEP = {
    "wgmma STAGES=2": ("wgmma", {"constexpr int STAGES = 4;":
                                 "constexpr int STAGES = 2;"}),
    "wgmma STAGES=3": ("wgmma", {"constexpr int STAGES = 4;":
                                 "constexpr int STAGES = 3;"}),
    "wgmma RPW=1 (BN=64 tile 4 rows)": (
        "wgmma", {"RPW = BN == 64 ? 2 : 1;": "RPW = 1;"}),
    "direct DROWS=1": ("direct", {"constexpr int DROWS = 8;":
                                  "constexpr int DROWS = 1;"}),
    "direct DROWS=4": ("direct", {"constexpr int DROWS = 8;":
                                  "constexpr int DROWS = 4;"}),
}
EDGES = [((1, 6, 40, 16), 64), ((1, 7, 33, 24), 130), ((2, 9, 29, 64), 64),
         ((1, 2, 2, 64), 128), ((1, 6, 40, 80), 192), ((3, 37, 29, 5), 7),
         ((2, 7, 130, 1), 64)]
UNET2_CONVS = [("e1.conv1", 512, 1, 64), ("e1.conv2", 512, 64, 64),
               ("e2.conv1", 256, 64, 128), ("e2.conv2", 256, 128, 128),
               ("e3.conv1", 128, 128, 256), ("e3.conv2", 128, 256, 256),
               ("d2.conv1", 256, 256, 128), ("d2.conv2", 256, 128, 128),
               ("d1.conv1", 512, 128, 64), ("d1.conv2", 512, 64, 64)]


def build_all() -> dict:
    """Build every setting in parallel; setting -> (library, registers)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (variant, subs) in SWEEP.items():
        src = next(s for (v, _), (s, _) in frc._ENTRY.items() if v == variant)
        text = (_cuda_build.CSRC / f"{src}.cu").read_text()
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {src}.cu")
            text = text.replace(old, new)
        stem = OUT / "".join(c if c.isalnum() else "_" for c in name)
        stem.with_suffix(".cu").write_text(text)
        cmd = [_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS, "-o",
               str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        libs[name] = (ctypes.CDLL(str(stem.with_suffix(".so"))), regs)
    return libs


def run(lib, entry, x, w, b):
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, W, C = x.shape
    out = torch.empty((B, H, W, w.shape[3]), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H,
             W, C, w.shape[3], 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return out


def inputs(shape, cout, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[-1]
    x = torch.randn(shape, device="cuda", generator=g)
    w = torch.randn((3, 3, C, cout), device="cuda", generator=g) / (
        3 * C ** 0.5)
    b = 0.1 * torch.randn(cout, device="cuda", generator=g)
    return x.to(dtype), w.to(dtype), b.to(dtype)


def within_tolerance(got, want) -> bool:
    """chip_smoke.py's B1 tolerance against the plain version in f32."""
    err = (got.float() - want).abs()
    if got.dtype == torch.bfloat16:
        tol = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)
    else:
        tol = 1e-4 * want.abs()
    return bool((err <= tol + 1e-4).all())


def event_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_sweep: CUDA is not available", file=sys.stderr)
        return 2
    disable_tf32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    libs = build_all()
    for name, (_, regs) in libs.items():
        print(f"{name}: ptxas {regs}")
    settings = {}  # (variant, dtype) -> [setting names]
    for name, (variant, _) in SWEEP.items():
        for key in frc._ENTRY:
            if key[0] == variant:
                settings.setdefault(key, []).append(name)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, cout in EDGES:
            key = (frc._variant(shape[-1], dtype), dtype)
            x, w, b = inputs(shape, cout, dtype, sum(shape) + cout)
            want = frc.conv3x3_reflect_fused_plain(x.float(), w.float(),
                                                   b.float(), True)
            for name in settings.get(key, []):
                got = run(libs[name][0], frc._ENTRY[key][1], x, w, b)
                torch.cuda.synchronize()
                if not within_tolerance(got, want):
                    raise RuntimeError(f"{name} {shape}->{cout}: != plain")
    print("every setting = plain at the edge shapes")
    totals = {}
    for dtype in (torch.bfloat16, torch.float32):
        for layer, S, C, Co in UNET2_CONVS:
            key = (frc._variant(C, dtype), dtype)
            if not settings.get(key):
                continue
            x, w, b = inputs((32, S, S, C), Co, dtype, S + C)
            row = {"layer": layer, "dtype": str(dtype)[6:],
                   "variant": key[0]}
            row["committed"] = event_ms(
                lambda: frc.conv3x3_reflect_fused(x, w, b, relu=True))
            for name in settings[key]:
                row[name] = event_ms(
                    lambda: run(libs[name][0], frc._ENTRY[key][1], x, w, b))
            row["committed, again"] = event_ms(
                lambda: frc.conv3x3_reflect_fused(x, w, b, relu=True))
            print("b1_sweep: " + json.dumps(row))
            for k, v in row.items():
                if isinstance(v, float):
                    tk = f"{key[0]} {row['dtype']}: {k}"
                    totals[tk] = totals.get(tk, 0.0) + v
            del x, w, b
    print("b1_sweep totals (ms, B=32, the unet_2 layers of each variant): "
          + json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
