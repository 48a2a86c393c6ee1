#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``wsunet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

It drives the port's two paths as a user would call them and holds every
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
5. times: B2 and its plain version at B=128 and B=8, 512x512, with the
   bound (device time from CUDA-graph replay, and B2's time per call when
   launched from Python); U-Net batch throughput at B=32 in bf16 and f32.
6. where the time goes: torch.profiler over the U-Net batch step, the
   serving step and the attack sweep (device busy share, top kernels).

Every phase runs unguarded: a failure raises and the exit code is not 0.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits with code 2 and
prints no result.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

FILTERS = ["KB", "AVG", "AVG9", "1"]
WEIGHTS = [0, 1, -1]
# B2's tolerance, that of tests/test_pallas_ws.py: f32 partial sums are
# taken in another order than the plain version's.
RTOL, ATOL = 1e-4, 1e-6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores, same source
ALPHA = 0.4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(n: int, title: str, t0: float) -> float:
    print(f"[phase {n}] {title}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return time.perf_counter()


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
            "top": [[n[:70], ms, ms / busy]
                    for n, ms in sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:top]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from wsunet_tpu_torch._device import disable_tf32
    from wsunet_tpu_torch.models import get_model, init_unet
    from wsunet_tpu_torch.ops import NAMED_FILTERS_2D, fused_ws, ws_attack
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
    t = phase(4, "U-Net serving path", t)

    # ---- 5. times
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

    flop_img = 2 * unet_macs(2, 512)
    for dtype in (torch.bfloat16, torch.float32):
        m = copy.deepcopy(model).to(device=dev, dtype=dtype)
        m.compute_dtype = dtype
        batch = [torch.from_numpy(smooth_covers(32, 512, seed=8 + i)).to(dev)
                 for i in range(2)]
        ms = cuda_ms(lambda x: predict_batch(m, x), batch, reps=3, iters=3)
        print(f"unet_2 batch throughput, B=32, 512x512, {str(dtype)[6:]}: "
              f"{ms:.3f} ms/batch = {32e3 / ms:.1f} img/s "
              f"({32 * flop_img / (ms * 1e-3) / 1e12:.1f} TFLOP/s at "
              f"{flop_img:.4g} FLOP/img)")
        del m, batch
    t = phase(5, "times", t)

    # ---- 6. where the time goes (torch.profiler; a measurement, so a
    # profiler that sees no device events prints "not measured")
    m = copy.deepcopy(model).to(device=dev, dtype=torch.bfloat16)
    m.compute_dtype = torch.bfloat16
    x32 = torch.from_numpy(smooth_covers(32, 512, seed=10)).to(dev)
    x1 = img[0]
    for label, fn, steps in [
            ("unet_2 bf16 batch step, B=32", lambda: predict_batch(m, x32),
             2),
            ("bf16 serving, b1", lambda: server.predict(x1), 20),
            ("attack_sweep KB, 4 batches of 8",
             lambda: attack_sweep(cover_batches, kernel_name="KB"), 5)]:
        prof = device_profile(fn, steps)
        if prof["busy_share"] is None:
            print(f"profile {label}: not measured (no device events)")
        else:
            print(f"profile {label}: " + json.dumps(prof))
    del m, x32
    t = phase(6, "where the time goes", t)

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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
