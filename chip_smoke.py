#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``wsunet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

It drives the port's paths as a user would call them and holds every
kernel against its plain PyTorch version:

1. device: the card's name and power limit; TF32 off.
2. kernel B2 (the fused WS attack, Triton) against its plain version, for
   KB/AVG/AVG9/"1" x weighted {0, 1, -1}, at the shapes the paths give it
   (B=8 and B=128 at 512x512) and at ragged shapes.
3. the filter-attack path: ``attack_sweep`` with KB and KB-w over seeded
   smooth covers and LSB-replacement stego (alpha 0.4), with the launch
   count of B2 read around it, against the plain path (``ws_attack``).
4. the U-Net serving path: ``unet_2`` at full width on seeded weights,
   f32 on the card against f32 on the CPU for one 512x512 image, then the
   bf16 ``UNetWSServer`` (``predict``, ``predict_many``,
   ``measure_latency``).
5. kernel B1 (the reflect-padded 3x3 conv, CUDA C++, three variants:
   ``wgmma``, ``direct``, ``fma``): the nvcc build of its two sources in
   parallel, with ptxas' registers, shared memory and spills for every
   kernel; then B1 against its plain version at the 10 ``unet_2`` layer
   shapes at 512x512 (B=2), f32 and bf16 (bf16 twice, to catch a race),
   ReLU on and off, at each variant's edge shapes (C = 16, 24, 48, 80;
   Cout = 3, 7, 8, 130, 192; W = 29 and 130; H = W = 2; bf16 C = 130 and
   C = 1), and at one input of more than 2^31 elements; each case checks
   that the variant ``_variant`` names is the one that launched.
6. the fast-conv U-Net path: ``unet_2`` with ``fast_conv=True`` (every 3x3
   conv through B1) against ``fast_conv=False`` in f32, with B1's launch
   counts per variant read around each forward (f32: 9 ``fma`` + 1
   ``direct``; bf16: 9 ``wgmma`` + 1 ``direct``); the bf16 ``UNetWSServer``
   on it; the saliency gradient through B1 against the cuDNN route.
7. times: B2 and its plain version at B=128 and B=8, 512x512, with the
   bound (device time from CUDA-graph replay, and B2's time per call when
   launched from Python); B1 per layer shape at B=32, 512x512, bf16 and
   f32, by variant, beside its bound, its plain version and cuDNN's
   reflect-pad conv in channels-last and in the model's own NCHW layout;
   U-Net batch throughput at B=32 in bf16 and f32 for ``fast_conv`` in
   {False, "borderfix", True}.
8. where the time goes: torch.profiler over the U-Net batch step (each
   ``fast_conv`` route), the serving step and the attack sweep (device
   busy share, top kernels).

Every phase runs unguarded: a failure raises and the exit code is not 0.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits with code 2 and
prints no result.
"""

import copy
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

FILTERS = ["KB", "AVG", "AVG9", "1"]
WEIGHTS = [0, 1, -1]
# B2's tolerance, that of tests/test_pallas_ws.py: f32 partial sums are
# taken in another order than the plain version's.
RTOL, ATOL = 1e-4, 1e-6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores, same source
BF16_OPS_PER_S = 989e12     # bf16 tensor cores, dense, same source
ALPHA = 0.4
FAST_CONV = [False, "borderfix", True]
# kernels that pad or change the layout around the convs (reflect pad,
# cuDNN's NCHW<->NHWC transposes)
LAYOUT_KERNELS = ("reflection_pad", "nchwToNhwc", "nhwcToNchw")
# the 3x3 reflect convs of unet_2 at 512x512, in forward order:
# (name, H = W, C_in, C_out)
UNET2_CONVS = [("e1.conv1", 512, 1, 64), ("e1.conv2", 512, 64, 64),
               ("e2.conv1", 256, 64, 128), ("e2.conv2", 256, 128, 128),
               ("e3.conv1", 128, 128, 256), ("e3.conv2", 128, 256, 256),
               ("d2.conv1", 256, 256, 128), ("d2.conv2", 256, 128, 128),
               ("d1.conv1", 512, 128, 64), ("d1.conv2", 512, 64, 64)]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(n: int, title: str, t0: float) -> float:
    print(f"[phase {n}] {title}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return time.perf_counter()


def b1_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """Max |got - want| and whether B1 is within its tolerance of its
    plain version run in f32 on the same inputs.  f32 (TF32 off): rtol
    1e-4, atol 1e-4, sums of up to 9*C = 2,304 terms in another order.
    bf16: one bf16 ulp of the output (the kernel rounds its f32 sum once)
    plus atol 1e-4 for values near 0."""
    err = (got.float() - want).abs()
    if got.dtype == torch.bfloat16:
        tol = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)
    else:
        tol = 1e-4 * want.abs()
    return float(err.max()), bool((err <= tol + 1e-4).all())


def ptxas_lines(log: str) -> list:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: the kernel
    (demangled by hand), its registers, shared memory and spills."""
    names = {"ILi128EE": "<128>", "ILi64EE": "<64>",
             "I13__nv_bfloat16EE": "<bf16>", "IfEE": "<f32>"}
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?"
                      r"(wgmma_kernel|direct_kernel|fma_kernel)(I\w+?EE)?",
                      line)
        if m:
            name = m.group(1) + names.get(m.group(2) or "", "")
        elif name and ("spill" in line or "registers" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return [f"{k}: {'; '.join(v)}" for k, v in out.items()]


def conv_inputs(shape, cout, dtype, seed):
    """Seeded NHWC x, HWIO w (scaled so outputs are O(1)) and b on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[-1]
    x = torch.randn(shape, device="cuda", generator=g, dtype=dtype)
    w = torch.randn((3, 3, C, cout), device="cuda", generator=g) / (
        3 * C ** 0.5)
    b = 0.1 * torch.randn(cout, device="cuda", generator=g)
    return x, w.to(dtype), b.to(dtype)


def smooth_covers(n: int, size: int, seed: int) -> np.ndarray:
    """Seeded smooth uint8 covers: a low-frequency pattern plus mild
    noise, [n, size, size]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    f = rng.uniform(0.01, 0.06, (n, 2, 1, 1)).astype(np.float32)
    ph = rng.uniform(0, 6.28, (n, 2, 1, 1)).astype(np.float32)
    img = 128 + 60 * np.sin(f[:, 0] * yy + ph[:, 0]) * \
        np.cos(f[:, 1] * xx + ph[:, 1])
    img += rng.normal(0, 2, img.shape).astype(np.float32)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def lsb_replace(x: np.ndarray, alpha: float, seed: int) -> np.ndarray:
    """LSB replacement at rate alpha: a random alpha share of the pixels
    gets a random LSB (so about alpha/2 of them change)."""
    rng = np.random.default_rng(seed)
    sel = rng.random(x.shape) < alpha
    bits = rng.integers(0, 2, x.shape, dtype=np.uint8)
    return np.where(sel, (x & 0xFE) | bits, x).astype(np.uint8)


def unet_macs(nsteps: int, size: int) -> int:
    """Multiply-accumulates of one U-Net forward on a size x size image,
    from the layer shapes (3x3 convs, 2x2 stride-2 transposed convs, the
    1x1 head)."""
    w = [64, 128, 256, 512, 1024]
    px = [(size >> s) ** 2 for s in range(nsteps + 1)]
    macs = 9 * (1 * w[0] + w[0] * w[0]) * px[0] + w[0] * px[0]
    for s in range(1, nsteps + 1):
        macs += 9 * (w[s - 1] * w[s] + w[s] * w[s]) * px[s]        # e<s+1>
        macs += w[s] * w[s - 1] * 4 * px[s]                        # up<s>
        macs += 9 * (2 * w[s - 1] * w[s - 1] + w[s - 1] ** 2) * px[s - 1]
    return macs


def cuda_ms(fn, inputs, reps: int = 5, iters: int = 20) -> float:
    """Median over ``reps`` of the mean time of one call, by CUDA events.
    Each call takes the next of ``inputs`` in turn, so that inputs larger
    than the L2 cache in total are read from device memory."""
    for i in range(3):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def graph_ms(fn, inputs, reps: int = 5, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls (rotating over ``inputs``)
    captured in a CUDA graph, replayed ``reps`` times, median of the mean
    by CUDA events.  The replay launches without Python, so what this
    measures is the card's time, not the host's time to enqueue."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times))


def device_profile(fn, steps: int, top: int = 6) -> dict:
    """Run ``fn`` ``steps`` times under torch.profiler: host wall time and
    device busy time per step (sum of the card's kernel and copy events,
    one stream) and the kernels that take most of it.  The profiler's own
    cost inflates the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "busy_share": busy / wall_ms if by_name else None,
            "layout_ms": {pat: sum(ms for n, ms in by_name.items()
                                   if pat in n) for pat in LAYOUT_KERNELS},
            "top": [[n[:70], ms, ms / busy]
                    for n, ms in sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:top]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from wsunet_tpu_torch._device import disable_tf32
    from wsunet_tpu_torch.analyses import unet_saliency
    from wsunet_tpu_torch.models import get_model, init_unet
    from wsunet_tpu_torch.ops import (NAMED_FILTERS_2D, _cuda_build,
                                      fused_reflect_conv, fused_ws,
                                      ws_attack)
    from wsunet_tpu_torch.serve import UNetWSServer, measure_latency
    from wsunet_tpu_torch.ws import (attack_sweep, parse_filter_model,
                                     predict_batch)

    t_all = t = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    disable_tf32()
    t = phase(1, "device", t)

    # ---- 2. B2 against its plain version on the card
    covers = smooth_covers(128, 512, seed=1)
    mixed = covers.copy()
    mixed[1::2] = lsb_replace(covers[1::2], ALPHA, seed=2)
    rng = np.random.default_rng(3)
    mixed[::7] = rng.integers(0, 256, mixed[::7].shape, dtype=np.uint8)
    x128 = torch.from_numpy(mixed).to(dev)
    shapes = {"128x512x512": x128, "8x512x512": x128[:8].contiguous()}
    for shape in [(3, 37, 53), (3, 3, 3), (2, 5, 130), (2, 130, 257)]:
        shapes["x".join(map(str, shape))] = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    max_err = 0.0
    for kname in FILTERS:
        for w in WEIGHTS:
            for shape, x in shapes.items():
                got = fused_ws.ws_attack_fused(x, kname, w)
                want = fused_ws.ws_attack_fused_plain(x, kname, w)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                      f"B2 {kname} weighted={w} {shape}: max |err| {err}")
    print(f"B2 = plain at rtol {RTOL}, atol {ATOL} for {len(FILTERS)} "
          f"filters x {len(WEIGHTS)} weightings x {len(shapes)} shapes "
          f"({', '.join(shapes)}); max |err| {max_err:.3e}")
    t = phase(2, "B2 against its plain version", t)

    # ---- 3. the filter-attack path
    cov8 = smooth_covers(32, 512, seed=4)
    steg8 = lsb_replace(cov8, ALPHA, seed=5)
    cover_batches = [cov8[i:i + 8] for i in range(0, 32, 8)]
    stego_batches = [steg8[i:i + 8] for i in range(0, 32, 8)]
    configs = ["KB", "KB-w"]
    results = {}
    fused_ws.reset_launches()
    for model_name in configs:
        kname, weighted, _ = parse_filter_model(model_name)
        results[model_name] = (
            attack_sweep(cover_batches, kernel_name=kname, weighted=weighted),
            attack_sweep(stego_batches, kernel_name=kname, weighted=weighted))
    attack_launches = fused_ws.launches
    want_launches = len(configs) * (len(cover_batches) + len(stego_batches))
    check(attack_launches == want_launches,
          f"B2 launched {attack_launches} times on the attack path, "
          f"expected {want_launches}")
    for model_name in configs:
        kname, weighted, _ = parse_filter_model(model_name)
        for got, batches in zip(results[model_name],
                                (cover_batches, stego_batches)):
            plain = torch.cat([ws_attack(
                torch.from_numpy(b).to(dev),
                pixel_kernel=NAMED_FILTERS_2D[kname], weighted=weighted)
                for b in batches]).cpu().numpy()
            check(got.shape == (32,) and np.all(np.isfinite(got)),
                  f"{model_name}: bad output {got.shape}")
            check(np.allclose(got, plain, rtol=RTOL, atol=ATOL),
                  f"{model_name}: attack path != plain path, max |err| "
                  f"{np.abs(got - plain).max()}")
        c, s = results[model_name]
        print(f"{model_name}: mean beta_hat covers {c.mean():.5f}, "
              f"stego {s.mean():.5f} (alpha/2 = {ALPHA / 2}); "
              f"= plain path (ws_attack)")
        check(abs(s.mean() - ALPHA / 2) < 0.05 and abs(c.mean()) < 0.05,
              f"{model_name}: estimates off alpha/2")
    print(f"attack path: B2 launches {attack_launches} "
          f"({len(configs)} configs x {2 * len(cover_batches)} batches of "
          "8x512x512)")
    t = phase(3, "filter-attack path", t)

    # ---- 4. the U-Net serving path
    model = init_unet(get_model("unet_2"), seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 1_861_697, f"unet_2 has {n_params} parameters")
    img = smooth_covers(1, 512, seed=6)
    b_cpu, l_cpu = predict_batch(model, img, device="cpu")
    model_gpu = copy.deepcopy(model).to(dev)
    fused_ws.reset_launches()
    fused_reflect_conv.reset_launches()
    b_gpu, l_gpu = predict_batch(model_gpu, img)
    b_gpu, l_gpu = float(b_gpu[0]), float(l_gpu[0])
    b_cpu, l_cpu = float(b_cpu[0]), float(l_cpu[0])
    print(f"unet_2 f32, 512x512: card beta {b_gpu:.8f} l1 {l_gpu:.6f}; "
          f"CPU beta {b_cpu:.8f} l1 {l_cpu:.6f}; |d beta| "
          f"{abs(b_gpu - b_cpu):.3e}, rel d l1 "
          f"{abs(l_gpu - l_cpu) / l_cpu:.3e}")
    # both f32 with TF32 off; the conv sums differ in order (cuDNN vs the
    # CPU's kernels), ~1e-7 relative on each of 13 layers' outputs
    check(abs(b_gpu - b_cpu) <= 1e-5, "U-Net beta: card != CPU")
    check(abs(l_gpu - l_cpu) <= 1e-4 * l_cpu, "U-Net l1: card != CPU")

    server = UNetWSServer(model)
    b16, l16 = server.predict(img[0])
    print(f"bf16 server: beta {b16:.6f} l1 {l16:.6f}")
    check(np.isfinite(b16) and np.isfinite(l16), "bf16 server not finite")
    check(abs(b16 - b_gpu) < 5e-3 and abs(l16 - l_gpu) < 0.5,
          "bf16 server far from f32")
    imgs = list(smooth_covers(32, 512, seed=7))
    serial = np.asarray([server.predict(im) for im in imgs])
    streamed = np.asarray(list(server.predict_many(iter(imgs))))
    check(streamed.shape == (32, 2), "predict_many lost results")
    # the same kernels on the same inputs, in the same order
    check(np.allclose(streamed, serial, rtol=1e-6, atol=1e-7),
          "predict_many != serial predict")
    lat = measure_latency(server, reps=30)
    unet_launches = fused_ws.launches
    print("serving (bf16, b1, 512x512): " + json.dumps(lat))
    print(f"U-Net path: B2 launches {unet_launches} (it has no kernel of "
          "its own: convolutions are cuDNN's, as XLA's in the JAX package)")
    check(unet_launches == 0, "B2 ran on the U-Net path")
    check(fused_reflect_conv.launches == 0,
          "B1 ran on the fast_conv=False U-Net path")
    t = phase(4, "U-Net serving path", t)

    # ---- 5. B1: build, then against its plain version on the card
    t_build = time.perf_counter()
    _cuda_build.load_all(fused_reflect_conv.SOURCES)
    print(f"B1 build (nvcc, sm_90a, {len(fused_reflect_conv.SOURCES)} "
          f"sources in parallel): {time.perf_counter() - t_build:.1f} s")
    for src in fused_reflect_conv.SOURCES:
        build = _cuda_build.build_info(src)
        print(f"  csrc/{src}.cu: nvcc {build['seconds']:.1f} s")
        for line in ptxas_lines(build["log"]):
            print("  ptxas: " + line)
    b1_err_max = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0

    def b1_case(label, x, w, b, relu, want_of=None):
        nonlocal n_cases
        variant = fused_reflect_conv._variant(x.shape[-1], x.dtype)
        before = fused_reflect_conv.launches_by_variant[variant]
        got = fused_reflect_conv.conv3x3_reflect_fused(x, w, b, relu=relu)
        torch.cuda.synchronize()
        check(fused_reflect_conv.launches_by_variant[variant] == before + 1,
              f"B1 {label}: variant {variant} did not launch")
        if want_of is None:
            want = fused_reflect_conv.conv3x3_reflect_fused_plain(
                x.float(), w.float(), b.float(), relu)
        else:
            got, want = want_of(got)
        torch.cuda.synchronize()
        err, ok = b1_err(got, want)
        b1_err_max[x.dtype] = max(b1_err_max[x.dtype], err)
        n_cases += 1
        check(ok, f"B1 {label} {str(x.dtype)[6:]} relu={relu} ({variant}): "
                  f"max |err| {err}")

    # each variant's edges: C = 16 (the wgmma/fma boundary), 24, 48, 80
    # (chunk tails), Cout = 3, 7, 8, 130, 192 (against 64/128-wide tiles),
    # W = 29 and 130 against 64-column runs, H = W = 2, C = 130 (bf16:
    # direct), C = 1, 5, 9 (direct)
    edges = [((3, 37, 29, 5), 7), ((1, 2, 2, 1), 3), ((2, 9, 130, 64), 64),
             ((1, 20, 20, 9), 130), ((1, 6, 40, 16), 64),
             ((1, 6, 40, 24), 130), ((1, 6, 40, 48), 64),
             ((1, 6, 40, 80), 192), ((1, 7, 33, 64), 8),
             ((1, 7, 33, 64), 3), ((1, 7, 33, 16), 7), ((2, 9, 29, 64), 64),
             ((1, 2, 2, 64), 64), ((1, 2, 2, 64), 128), ((1, 9, 9, 130), 70),
             ((2, 7, 130, 1), 64)]
    for dtype, passes in ((torch.float32, 1), (torch.bfloat16, 2)):
        for rep in range(passes):
            for layer, S, C, Co in UNET2_CONVS:
                x, w, b = conv_inputs((2, S, S, C), Co, dtype,
                                      seed=S + C + Co + 100 * rep)
                for relu in (False, True):
                    b1_case(f"{layer} 2x{S}x{S}x{C}->{Co} pass {rep}", x, w,
                            b, relu)
        for shape, Co in edges:
            x, w, b = conv_inputs(shape, Co, dtype, seed=sum(shape) + Co)
            for relu in (False, True):
                b1_case(f"{shape}->{Co}", x, w, b, relu)
        del x, w, b
    # 64-bit offsets: 66x512x512x128 bf16 is 2.2e9 elements; the last
    # image lies beyond 2^31 elements and is compared alone
    big = (66, 512, 512, 128)
    x, w, b = conv_inputs(big, 64, torch.bfloat16, seed=11)
    b1_case(f"{big}->64 (last image)", x, w, b, True, want_of=lambda got: (
        got[-1:], fused_reflect_conv.conv3x3_reflect_fused_plain(
            x[-1:].float(), w.float(), b.float(), True)))
    del x, w, b
    torch.cuda.empty_cache()
    print(f"B1 = plain in {n_cases} cases (10 unet_2 layer shapes at "
          f"2x512x512, f32 once and bf16 twice, and {len(edges)} edge "
          "shapes, f32 and bf16, ReLU on and off; bf16 66x512x512x128->64, "
          "last image); max |err| f32 "
          f"{b1_err_max[torch.float32]:.3e} (rtol 1e-4, atol 1e-4), bf16 "
          f"{b1_err_max[torch.bfloat16]:.3e} (1 bf16 ulp + 1e-4), "
          "against the plain version in f32 on the same inputs; launches "
          f"by variant {json.dumps(fused_reflect_conv.launches_by_variant)}")
    t = phase(5, "B1 build and against its plain version", t)

    # ---- 6. the fast-conv U-Net path (B1's main path)
    # B1's launches on this path, by variant: the counts are read and reset
    # around each step and summed here
    b1_path = dict.fromkeys(fused_reflect_conv.launches_by_variant, 0)

    def b1_take() -> dict:
        got = dict(fused_reflect_conv.launches_by_variant)
        for k, v in got.items():
            b1_path[k] += v
        fused_reflect_conv.reset_launches()
        return got

    fast_model = copy.deepcopy(model)
    fast_model.fast_conv = True
    imgs4 = smooth_covers(4, 512, seed=12)
    b_ref, l_ref = predict_batch(model_gpu, imgs4)
    fast_gpu = copy.deepcopy(fast_model).to(dev)
    fused_reflect_conv.reset_launches()
    b_fast, l_fast = predict_batch(fast_gpu, imgs4)
    f32_forward = b1_take()
    d_beta = float((b_fast - b_ref).abs().max())
    d_l1 = float(((l_fast - l_ref).abs() / l_ref).max())
    print(f"unet_2 f32 4x512x512, fast_conv=True vs False on the card: "
          f"max |d beta| {d_beta:.3e}, max rel d l1 {d_l1:.3e}; "
          f"B1 launches in one f32 forward: {json.dumps(f32_forward)}")
    check(f32_forward == {"wgmma": 0, "direct": 1, "fma": 9},
          f"B1 launches in one f32 unet_2 forward: {f32_forward}")
    check(d_beta <= 1e-5 and d_l1 <= 1e-4,
          "fast_conv=True != fast_conv=False")
    fast_server = UNetWSServer(fast_model)
    b1_take()  # the server's warm-up
    fb, fl = fast_server.predict(img[0])
    bf16_forward = b1_take()
    print(f"bf16 server, fast_conv=True: beta {fb:.6f} l1 {fl:.6f} "
          f"(fast_conv=False: beta {b16:.6f} l1 {l16:.6f}); B1 launches in "
          f"one bf16 forward: {json.dumps(bf16_forward)}")
    check(bf16_forward == {"wgmma": 9, "direct": 1, "fma": 0},
          f"B1 launches in one bf16 unet_2 forward: {bf16_forward}")
    check(np.isfinite(fb) and np.isfinite(fl), "fast bf16 server not finite")
    check(abs(fb - b_gpu) < 5e-3 and abs(fl - l_gpu) < 0.5,
          "fast bf16 server far from f32")
    fserial = np.asarray([fast_server.predict(im) for im in imgs[:8]])
    fstreamed = np.asarray(list(fast_server.predict_many(iter(imgs[:8]))))
    check(np.allclose(fstreamed, fserial, rtol=1e-6, atol=1e-7),
          "fast predict_many != serial predict")
    fast_lat = measure_latency(fast_server, reps=10)
    b1_take()
    print("serving fast_conv=True (bf16, b1, 512x512): " +
          json.dumps(fast_lat))

    # saliency through B1 (forward B1, backward the plain VJP)
    sal_img = smooth_covers(1, 512, seed=13)[0]
    patches = {}
    for fc, m in ((False, model_gpu), (True, fast_gpu)):
        patches[fc] = unet_saliency(m, sal_img, 200, 300)
        sal = b1_take()
        want = {"wgmma": 0, "direct": 1, "fma": 9} if fc else \
            dict.fromkeys(sal, 0)
        check(sal == want, f"saliency fast_conv={fc}: B1 launches {sal}")
    d_sal = float(np.abs(patches[True] - patches[False]).max())
    sal_max = float(np.abs(patches[False]).max())
    print(f"saliency 512x512 f32 at (200, 300), 17x17 patch: max |patch| "
          f"{sal_max:.4e}, fast_conv=True vs False max |d| {d_sal:.3e}")
    # both f32; a 2x2 max-pool window with two values within ~1e-6 can
    # route the gradient to the other element when the conv sums differ
    # in order (tests/test_torch_saliency.py), hence a bound relative to
    # the patch
    check(np.all(np.isfinite(patches[True])) and sal_max > 0,
          "saliency patch not finite or zero")
    check(d_sal <= 1e-3 * sal_max, "saliency through B1 != cuDNN route")
    b1_launches = sum(b1_path.values())
    print(f"fast-conv path: B1 launches {b1_launches} by variant "
          f"{json.dumps(b1_path)} (10 a forward: predict_batch, server "
          "warm-up, predict, predict_many, measure_latency, saliency)")
    check(b1_launches % len(UNET2_CONVS) == 0 and all(b1_path.values()),
          f"B1 launches {b1_path} on the fast-conv path")
    del fast_gpu
    t = phase(6, "fast-conv U-Net path", t)

    # ---- 7. times
    b2_entry = None
    for B in (128, 8):
        bufs = [x128[:B].clone() for _ in range(4 if B == 128 else 1)]
        for kname in FILTERS:
            for w in WEIGHTS:
                def kernel(x):
                    return fused_ws.ws_attack_fused(x, kname, w)

                def plain(x):
                    return fused_ws.ws_attack_fused_plain(x, kname, w)

                ms = graph_ms(kernel, bufs)
                eager_ms = cuda_ms(kernel, bufs)
                plain_ms = graph_ms(plain, bufs, reps=3, iters=4)
                cost = fused_ws.ws_fused_cost(B, 512, 512, kname, w)
                t_bytes = 1e3 * cost["bytes"] / HBM_BYTES_PER_S
                t_ops = 1e3 * cost["ops"] / F32_OPS_PER_S
                row = {"B": B, "filter": kname, "weighted": w, "ms": ms,
                       "eager_ms": eager_ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations",
                       "bytes": cost["bytes"], "ops": cost["ops"]}
                print("B2 time: " + json.dumps(row))
                if B == 128 and kname == "KB" and w == 0:
                    b2_entry = row
    print("B2 ms and plain_ms: device time of one call, from CUDA-graph "
          "replay; eager_ms: one call launched from Python (host-inclusive, "
          "what attack_sweep pays a batch). Inputs rotate over "
          "4 x 33.5 MB at B=128 (beyond the 50 MB L2); at B=8 one 2 MB "
          "batch stays in L2, as a freshly uploaded batch would.")
    print("B2 bound = max(bytes / 3.35e12 B/s, f32 ops / 67e12 op/s); "
          "bytes = B*H*W + 4*B, ops = ws_fused_cost (2*taps+4 a pixel, "
          "+38 weighted). No single PyTorch call computes B2: "
          "library_ms is null.")

    b1_rows = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.bfloat16, torch.float32):
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        for layer, S, C, Co in UNET2_CONVS:
            x, w, b = conv_inputs((32, S, S, C), Co, dtype, seed=S + C)
            xc = x.permute(0, 3, 1, 2)       # channels-last NCHW view
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            wn = w.permute(3, 2, 0, 1).contiguous()  # OIHW, as the model's

            def kernel(v):
                return fused_reflect_conv.conv3x3_reflect_fused(
                    v, w, b, relu=True)

            def plain(v):
                return fused_reflect_conv.conv3x3_reflect_fused_plain(
                    v, w, b, True)

            def library(v):
                return F.relu(F.conv2d(F.pad(v, (1, 1, 1, 1),
                                             mode="reflect"), wc, b))

            def library_nchw(v):
                return F.relu(F.conv2d(F.pad(v, (1, 1, 1, 1),
                                             mode="reflect"), wn, b))

            cost = fused_reflect_conv.conv_cost(32, S, S, C, Co,
                                                x.element_size())
            t_bytes = 1e3 * cost["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * cost["flops"] / peak
            row = {"layer": layer, "dtype": str(dtype)[6:],
                   "variant": fused_reflect_conv._variant(C, dtype),
                   "shape": [32, S, S, C, Co],
                   "ms": graph_ms(kernel, [x], reps=3, iters=2),
                   "plain_ms": graph_ms(plain, [x], reps=3, iters=2),
                   "library_ms": graph_ms(library, [xc], reps=3, iters=2)}
            del xc, wc
            xn = x.permute(0, 3, 1, 2).contiguous()
            row["library_nchw_ms"] = graph_ms(library_nchw, [xn], reps=3,
                                              iters=2)
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            row["tflops"] = cost["flops"] / row["ms"] / 1e9
            print("B1 time: " + json.dumps(row))
            b1_rows[dtype].append(row)
            del x, w, b, xn, wn
            torch.cuda.empty_cache()
    print("B1 ms, plain_ms, library_ms, library_nchw_ms: device time of one "
          "call, CUDA-graph replay, B=32 at 512x512 (each input > 50 MB "
          "L2). bound = max(bytes / 3.35e12 B/s, FLOPs / peak), peak "
          "989e12 bf16, 67e12 f32; bytes = x + w + b + out once, FLOPs = "
          "2*9*C*Cout*B*H*W. library_ms: cuDNN F.conv2d on the "
          "reflect-padded channels-last input + ReLU; library_nchw_ms: the "
          "same on a contiguous NCHW input and OIHW filter, the layout of "
          "the fast_conv=False model; same dtype.")
    for dtype, rows in b1_rows.items():
        keys = ("ms", "plain_ms", "bound_ms", "library_ms",
                "library_nchw_ms")
        tot = {k: sum(r[k] for r in rows) for k in keys}
        by = {k: sum(r["bound_ms"] for r in rows if r["bound_by"] == k)
              for k in ("bytes", "operations")}
        tot["bound_by"] = max(by, key=by.get)
        print(f"B1 10 layers of one unet_2 forward, B=32, {str(dtype)[6:]}: "
              + json.dumps(tot))
        for v in sorted({r["variant"] for r in rows}):
            part = {k: sum(r[k] for r in rows if r["variant"] == v)
                    for k in keys}
            print(f"  {v}: " + json.dumps(part))
        if dtype == torch.bfloat16:
            # the kernels line: one bf16 unet_2 forward's 10 launches, the
            # dtype the server runs in
            b1_entry = {k: tot[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
            check(tot["ms"] < tot["library_ms"],
                  "bf16 B1 slower than cuDNN's reflect-pad conv")

    flop_img = 2 * unet_macs(2, 512)
    step_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        batch = [torch.from_numpy(smooth_covers(32, 512, seed=8 + i)).to(dev)
                 for i in range(2)]
        for fc in FAST_CONV:
            m = copy.deepcopy(model).to(device=dev, dtype=dtype)
            m.compute_dtype = dtype
            m.fast_conv = fc
            ms = cuda_ms(lambda x: predict_batch(m, x), batch, reps=3,
                         iters=3)
            step_ms[dtype, fc] = ms
            print(f"unet_2 batch throughput, B=32, 512x512, "
                  f"{str(dtype)[6:]}, fast_conv={fc}: "
                  f"{ms:.3f} ms/batch = {32e3 / ms:.1f} img/s "
                  f"({32 * flop_img / (ms * 1e-3) / 1e12:.1f} TFLOP/s at "
                  f"{flop_img:.4g} FLOP/img)")
            del m
        del batch
    for dtype, rows in b1_rows.items():
        print(f"unet_2 {str(dtype)[6:]} B=32 step, fast_conv=False: "
              f"{step_ms[dtype, False]:.3f} ms; its 10 convs alone as cuDNN "
              "reflect-pad convs: NCHW (the model's layout) "
              f"{sum(r['library_nchw_ms'] for r in rows):.3f} ms, "
              f"channels-last {sum(r['library_ms'] for r in rows):.3f} ms; "
              f"fast_conv=True step {step_ms[dtype, True]:.3f} ms, its 10 "
              f"B1 launches alone {sum(r['ms'] for r in rows):.3f} ms")
    t = phase(7, "times", t)

    # ---- 8. where the time goes (torch.profiler; a measurement, so a
    # profiler that sees no device events prints "not measured")
    x32 = torch.from_numpy(smooth_covers(32, 512, seed=10)).to(dev)
    x1 = img[0]
    steps_of = []
    for fc in FAST_CONV:
        m = copy.deepcopy(model).to(device=dev, dtype=torch.bfloat16)
        m.compute_dtype = torch.bfloat16
        m.fast_conv = fc
        steps_of.append((f"unet_2 bf16 batch step, B=32, fast_conv={fc}",
                         lambda m=m: predict_batch(m, x32), 2))
    steps_of += [
        ("bf16 serving, b1", lambda: server.predict(x1), 20),
        ("bf16 serving, b1, fast_conv=True",
         lambda: fast_server.predict(x1), 5),
        ("attack_sweep KB, 4 batches of 8",
         lambda: attack_sweep(cover_batches, kernel_name="KB"), 5)]
    for label, fn, steps in steps_of:
        prof = device_profile(fn, steps)
        if prof["busy_share"] is None:
            print(f"profile {label}: not measured (no device events)")
            continue
        print(f"profile {label}: " + json.dumps(prof))
        if label.endswith("fast_conv=True"):
            check(not any(prof["layout_ms"].values()),
                  f"{label}: a reflect pad or layout transpose kernel ran")
    del steps_of, m, x32
    t = phase(8, "where the time goes", t)

    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "ws_attack_fused",
        "route": "triton",
        "source": "wsunet_tpu_torch/ops/_fused_ws_triton.py",
        "replaces": "wsunet_tpu/ops/pallas_ws.py:88",
        "launches": attack_launches,
        "max_abs_err": max_err,
        "ms": b2_entry["ms"],
        "plain_ms": b2_entry["plain_ms"],
        "bound_ms": b2_entry["bound_ms"],
        "bound_by": b2_entry["bound_by"],
        "library_ms": None,
    }, {
        "name": "conv3x3_reflect_fused",
        "route": "cuda",
        "source": "wsunet_tpu_torch/csrc/reflect_conv3x3_wgmma.cu",
        "sources": [f"wsunet_tpu_torch/csrc/{src}.cu"
                    for src in fused_reflect_conv.SOURCES],
        "replaces": "wsunet_tpu/experiments/pallas_reflect_conv.py:128",
        "launches": b1_launches,
        "launches_by_variant": b1_path,
        "max_abs_err": max(b1_err_max.values()),
        **b1_entry,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
