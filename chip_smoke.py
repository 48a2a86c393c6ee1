#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``wsunet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

It drives the port's paths as a user would call them and holds every
kernel against its plain PyTorch version:

1. device: the card's name and power limit; TF32 off.
2. the nvcc build of every kernel source in parallel (B1's two, B2's
   one), with ptxas' registers, shared memory and spills for every
   kernel; then kernel B2 (the fused WS attack, CUDA C++) against its
   plain version, for KB/AVG/AVG9/"1" x weighted {0, 1, -1}, at the shapes
   the paths give it (B=8 and B=128 at 512x512), at ragged shapes (widths
   15, 16, 17, 130, 257; fewer interior rows than a cluster has blocks;
   B=1; a base pointer not 16-byte aligned), with one launch a call, two
   calls bitwise equal, and on the last 4 images of an input of more than
   2^31 bytes (8200x512x512).
3. the filter-attack path: ``attack_batches`` with KB and KB-w over seeded
   smooth covers and LSB-replacement stego (alpha 0.4), with the launch
   count of B2 read around it, against the plain path (``ws_attack``).
4. the U-Net serving path: ``unet_2`` at full width on seeded weights,
   f32 on the card against f32 on the CPU for one 512x512 image, then the
   bf16 ``UNetWSServer`` (``predict``, ``predict_many``,
   ``measure_latency``).
5. kernel B1 (the reflect-padded 3x3 conv, CUDA C++, three variants:
   ``wgmma``, ``direct``, ``fma``; built in phase 2) against its plain
   version at the 10 ``unet_2`` layer
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
   launched from Python), and a CUDA-graph replay of B2 bitwise equal to
   its eager call; B1 per layer shape at B=32, 512x512, bf16 and
   f32, by variant, beside its bound, its plain version and cuDNN's
   reflect-pad conv in channels-last and in the model's own NCHW layout;
   U-Net batch throughput at B=32 in bf16 and f32 for ``fast_conv`` in
   {False, "borderfix", True}.
8. where the time goes: torch.profiler over the U-Net batch step (each
   ``fast_conv`` route), the serving step and the attack sweep, from numpy
   batches (pinned uploads) and from CPU tensors (pageable uploads), with
   the device busy share and the top kernels and copies.
9. the trained-weights detection path, on ``weights/golden/p128_lsbr.npz``
   (64 covers of ``data_ablation/p128`` and their LSBr stego at alpha 0.1
   and 0.01, with the JAX package's numbers on them): the trained LSBR
   ``unet_2`` loaded with ``load_pretrained_unet`` from ``weights/unet``
   on each ``fast_conv`` route; its f32 beta_hat and l1 (B1's launches
   counted) and KB, KB-w (B2, one launch a batch) and KB-sca (plain) held
   against JAX's; every B1 launch of the phase's forwards held against
   B1's plain version on the same activations (phase 5's bounds); bf16
   on B1 against the card's f32, within the JAX package's own bf16-to-f32
   distance on the same images; ``ws-eval``'s U-Net estimator on B1
   against cuDNN; the catalog pipeline (``data.pipeline.sweep_batches``)
   over the covers written as ``.npy`` files, one corrupt, through the
   device cache, B1 and B2, with NaN rows; AUC, P_E, wAUC and P_MD@5%FP
   from ``detect.roc_stats`` against JAX's; and a probe of the native PNG
   decoder (``io.native``), bitwise against the golden covers where it
   builds.
10. the B0 detection path, on the same images and
   ``weights/golden/p128_b0.npz`` (the JAX package's B0 and OLS numbers on
   them): both exported LSBR B0 runs (``load_pretrained_b0`` from
   ``weights/b0``) in f32 against JAX's P(stego), and in bf16 against the
   card's f32 within 1.25 times JAX's own bf16 distance; the ROC
   statistics of both ``roc --b0`` labels and of OLS against JAX's; OLS
   fitted on the card (gray and color4 taps, beta_hat, no B2 launch); the
   name-based catalog sweep (``detect.b0_eval.score_sweep``) over ``.npy``
   files, one corrupt; and both configurations at full width, 512x512,
   B=8 (``detector-eval``'s batch) and 32, f32 and bf16: img/s by host
   clock, device ms by CUDA-graph replay, peak memory, GMACs an image
   from the layer shapes and the share of the card's peak, and the top
   kernels from torch.profiler at B=32.
11. the U-Net training path (``train.train_unet``), which runs no TPU
   kernel (the JAX trainer trains on XLA convs and the plain WS loss; the
   phase checks that B1 and B2 do not launch): (a) the step on the
   committed LSBR weights with the JAX trainer's own draws
   (``weights/golden/p128_train_step.npz``, crop 64, B=4) against JAX's
   loss (rel 1e-4) and gradients (max|d|/max|g| 1e-3), and three AdamW
   steps under the cosine schedule (losses rel 1e-4, every parameter's
   norm rel 1e-5); (b) both committed recipes at full width, ``unet_2``
   on seeded 512x512 covers: LSBR (crop 512, B=4, f32 with TF32 off,
   augment, alpha 0.4, weighted l1ws lambda 0.25, cosine), LSBR in bf16
   and with HILLr, and dropout (crop 320, B=12, UniformDropout 0.1, l1, no
   stego), 5 timed steps each: step ms by CUDA events, img/s by host
   clock, peak memory, the busy share and top kernels of one profiled
   step; (c) the card against the CPU on the same draws (the golden step,
   and a dropout step at crop 48): loss rel 1e-4, gradients 1e-3; HILLr
   on 4x512x512 bitwise equal on both; (d) ``train_names`` on ``.npy``
   covers (the golden batches, 128x128) for 2 epochs of 2 steps, its run
   loaded with ``load_pretrained_unet`` (the weights of ``model/best``)
   and one batch served through ``predict_batch``.
12. the B0 training path (``train.train_b0``, ``train.bn_recalibrate``)
   and ``filters-eval``'s step, which run no TPU kernel (JAX trains B0 on
   XLA convs and has no Pallas kernel on ``filters-eval``; the phase
   checks that B1 and B2 do not launch): (a) the steps of
   ``weights/golden/p128_b0_train_step.npz`` (JAX's draws, B=2 pairs,
   128x128, from the committed strided run): the committed recipe
   (``freeze_bn``) against JAX's loss (rel 1e-4) and gradients
   (max|d|/max|g| 1e-3) and three AdamW steps; the live step (batch
   statistics, head dropout, the running update) in float64 on JAX's
   inputs against JAX's float64 step (1e-6), and in f32 against JAX's f32
   and float64 steps (loss rel and gradients 1e-3: the step's own f32
   noise); (b) both committed B0 recipes at full width, 512x512, B=2
   pairs, f32 (TF32 off) and bf16, 5 timed steps each: step ms by CUDA
   events, img/s by host clock (4 images a step), peak memory, and of one
   profiled step the busy share, the kernels launched and the top ones;
   (c) the card against the CPU on the recipe's golden
   draws; (d) ``train_names`` on ``.npy`` covers for 2 epochs of 2 steps,
   resumed from a copy of the committed strided run, its ``best.npz``
   loaded with ``load_pretrained_b0`` and scored by ``infer_b0``, then
   recalibrated (``recalibrate_names``: only the running statistics
   move); (e) ``filters-eval``'s step (``ws.mae_wmae``) on the golden
   covers against ``weights/golden/p128_filters.npz`` (every ``inbayer``,
   and the color4 planes), and timed at 512x512, B=128 (33 million cost
   values, beyond ``torch.quantile``'s 2^24), KB on the luminance plane.
13. the analyses and the serving CLI's loops, on the trained runs of
   ``weights/unet`` found by name, with every B1 launch held against B1's
   plain version on the same activations (phase 5's bounds) and B2 not
   launched: (a) on the 64 p128 covers and their LSBr stego at alpha 0.1
   as ``.npy`` files, on both ``fast_conv`` routes, against
   ``weights/golden/p128_analyses.npz`` (the JAX package's numbers):
   ``correlation``'s rows for 4 filters and 3 U-Nets
   (``analyses.correlation.correlation_rows``), ``error-boxes``'
   statistics (``residual_populations``, ``box_stats``), ``contour``'s
   difference images, ``saliency``'s patches at four points and
   ``sobel_locations``; (b) at full width, ``unet_2`` at 512x512: the
   saliency gradient at the subcommand's four points on B1 against
   cuDNN, ``serve``'s loops in bf16 with ``--fast-conv``
   (``serve.load_server``; ``stream_paths`` over 32 ``.npy`` paths,
   ``serve_lines`` over 8 lines, one of the wrong shape) against
   ``UNetWSServer.predict`` with 9 ``wgmma`` + 1 ``direct`` launches a
   request, and the correlation core over 64 seeded pairs on each route;
   then, without the per-launch check, ms a saliency point, the streamed
   img/s and ``measure_latency`` of ``serve`` on each route, and the
   correlation core's pairs/s; (c) the hooks: ``utils.profiling.profile``
   (``WSUNET_PROFILE``) around one saliency call writes a trace naming
   B1's kernels, and ``nan_check`` raises ``FloatingPointError`` at a NaN
   made by a torch op on the card and at B1's output.

14. the parallel path (``wsunet_tpu_torch.parallel``, on
   ``torch.distributed``): (a) a one-rank nccl group in this process:
   the KB and KB-w sweeps (B2), the fast-conv U-Net sweep (B1) and the
   strided B0 sweep over the 64 golden covers as ``.npy`` files, one
   corrupt, against the golden numbers, with every B1 and B2 launch held
   to its plain version and counted; ``ws_attack_spatial`` at 8x512x512
   (KB x weighted {0, 1, -1}) against B2 and the plain attack;
   ``infer_unet_spatial`` (trained ``unet_2``, f32, 4x512x512) against
   ``infer_unet``; the golden ``train_unet`` step and three B0 golden
   steps (live in float64, live in f32, the committed recipe in f32)
   against the same steps without a group, the f32 ones against JAX's
   f32 steps too (1e-3); (b) two gloo ranks on the card (this script
   again, ``--parallel-rank R 2 JOB``), each holding the same drive to
   (a): sweep rows bit for bit (B0's at rtol 1e-6), the spatial paths and
   the steps at (a)'s bounds, gloo taking CUDA tensors as they lie; (c)
   times, host clock: ``ws_attack_spatial`` at 128x512x512 beside B2 and
   the plain attack, ``infer_unet_spatial`` beside ``infer_unet`` at
   4x512x512 in f32 and bf16, the three sweeps' img/s over 128 512x512
   ``.npy`` covers at batch 8 (the CLI's default) at one and two ranks,
   and the trainer steps at 512x512 without a group and on the one-rank
   group, and on each of the two gloo ranks.
15. the bench (``wsunet_tpu_torch.bench``): (a) in this process, the
   headline step (``bench.make_step`` on ``bench.build_model``: seeded
   ``unet_2`` at full width on B1, the default route) at 8 and 128
   images of 512x512 in bf16 and at 8 and 32 in f32 (the subcommand's
   default batch and (b)'s), its B1 launches counted (9 ``wgmma`` + 1
   ``direct``; 9 ``fma`` + 1 ``direct``) and each held against B1's
   plain version (phase 5's bounds, every output row), its (beta_hat,
   l1) against the cuDNN route's; the latency section's bf16 server, its
   B1 launches held alike; the ``ws_fused`` section at B=128, its B2
   launches counted, each launch outside the timed CUDA graph held
   against B2's plain version (phase 2's bounds) and its parity with the
   plain attack for KB/AVG x weighted {0, 1, -1} at B2's tolerance; (b)
   ``python -m wsunet_tpu_torch bench --batch-size 128`` (bf16, B1) and
   ``--dtype float32 --batch-size 32`` as subprocesses, and ``run_bench``
   at B=32 with ``WSUNET_BENCH_FAST_CONV=borderfix`` and ``0``: each JSON
   record's keys and numbers (10 B1 launches a step on B1, the FLOPs,
   ``mfu``, ``ws_fused``'s parity, the floor keys, the latency and decode
   sections), printed with the card's name and power limit; (c) where the
   headline step's time goes at four configurations (``device_profile``:
   host wall, busy share, the top kernels) and its peak memory.
16. the detection path from PNG files: the CLI as a user runs it, each
   command a process in which pandas, PIL, cv2, matplotlib and seaborn
   cannot be imported (stub packages first on ``PYTHONPATH``; this
   script again, ``--cli-checked OUT ARGS``, which runs the CLI's
   ``main`` with every B1 and B2 launch held against its plain version
   and counted). (a) On the 64 committed p128 PNG covers and the golden
   JAX stego written by ``io.png.write_png``: the covers decode bit for
   bit; ``ws-eval`` (KB and KB-w on B2, ``UNet_l1ws`` on B1) and
   ``unet-eval --fast-conv`` give phase 9's in-memory beta_hat bit for
   bit, a corrupt cover (a bad CRC) the row its ``.npy`` gave in phase
   9; ``detector-eval`` within phase 10's bound of JAX's P(stego); ``roc
   --b0`` at each alpha within phase 9's bounds of JAX's AUC, wAUC, P_E
   and P_MD@5%FP, its figure not drawn (no matplotlib). (b) At 512x512:
   64 covers (four p256 covers tiled 2x2, from a seed) written by
   ``write_png``, ``simulate --method LSBr --alphas 0.1 0.4``, ``ws-eval``
   (KB, KB-w) and ``unet-eval --fast-conv`` over the 192 PNGs; then in
   this process, the per-launch check off, the sweeps' wall and img/s
   with the decode in the clock and the card's busy share, and the
   bench's ``decode_only`` (ms an image at 1 and 8 threads) and
   ``e2e_decode``, beside the card's name and power limit.
17. the holdout tables and the analyses from PNG files, each in a
   process without pandas, PIL, cv2, matplotlib and seaborn, every B1 and
   B2 launch held to its plain version and counted (``run_checked``).
   (a) ``detect.holdout_roc`` (this script again, ``--holdout-checked``)
   on phase 16 (a)'s p128 PNGs, two folds of ``data_ablation/p128``'s
   splits, KB and KB-w on B2, the LSBR U-Net and the strided B0: its
   per-image scores within phase 9's and 10's bounds of JAX's golden
   ones, its AUC and CI files the port's tables of those scores byte for
   byte, and within one near-tie of the tables of JAX's golden scores.
   (b) a user's analysis session on phase 16 (b)'s 64 512x512 covers,
   copied to a fresh folder: ``init-dataset`` (its splits against the
   stem hash recomputed here), ``simulate --alphas 1.0``,
   ``correlation``, ``error-boxes``, ``contour`` and ``saliency`` with
   ``--fast-conv`` (B1, f32): the CSVs read back, each figure not drawn
   named on stderr, the dots image decoded against ``sobel_locations``;
   each command's process time.

18. kernel B3 (the MBConv depthwise stage in one pass, CUDA C++) at each
   of the 16 depthwise stages of B0 without stem stride at 512x512, B=32:
   every launch held to its plain version, two calls and a CUDA-graph
   replay bitwise equal; device ms by CUDA-graph replay beside its bound
   (bytes over the card's bandwidth), the plain version's ms and the
   library yardstick's (PyTorch's batch norm, SiLU, pad, conv_depthwise2d
   and mean: the composition the model ran before B3, which the port
   never calls as one).  ``python3 chip_smoke.py --b3`` builds the kernels
   and runs phase 18 alone.
19. kernel B4 (the middle of Restormer's gated FFN in one pass, CUDA C++)
   at the 5 shapes of the 44 launches of a ``restormer_gray`` forward at
   512x512, B=32: every launch held to its plain version, two calls and a
   CUDA-graph replay bitwise equal; device ms by CUDA events
   (``cuda_ms``) beside its bound (bytes over the card's bandwidth), the
   plain version's ms and the library yardstick's (the module's grouped
   conv, ``chunk``, exact GELU and the product: what the model ran before
   B4, which the port never calls on the card in eval mode), and the
   forward's sum over its 44 launches; then one eval ``restormer_gray``
   forward at 512x512 and one at 500x500, B=1, each of 44 B4 launches.
   ``python3 chip_smoke.py --b4`` builds the kernels and runs phase 19
   alone, with ptxas' registers and spills of B4.

Every phase runs unguarded: a failure raises and the exit code is not 0.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits with code 2 and
prints no result.
"""

import copy
import json
import os
import pathlib
import re
import shutil
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
REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "weights" / "golden" / "p128_lsbr.npz"
GOLDEN_B0 = REPO / "weights" / "golden" / "p128_b0.npz"
GOLDEN_TRAIN = REPO / "weights" / "golden" / "p128_train_step.npz"
GOLDEN_B0_TRAIN = REPO / "weights" / "golden" / "p128_b0_train_step.npz"
GOLDEN_FILTERS = REPO / "weights" / "golden" / "p128_filters.npz"
B0_RUNS = {
    "strided": "260817154325-tpu-b0-alpha_mix0.1-0.05-0.01_grayscale_"
               "crossentropy_lr_2e-05_dr_0.2",
    "no stem stride": "260818140316-tpu-b0-nostride-alpha_mix0.1-0.05-0.01_"
                      "grayscale_crossentropy_lr_2e-05_dr_0.2"}
# P(stego) of the trained B0 runs against JAX (tests/test_torch_b0.py):
# f32 sums in another order move logits of up to 100 by about 3e-6
# relative, a P(stego) near 0.5 by up to 3.6e-5 on the CPU
B0_ATOL = 1e-4
B0_BF16_SLACK = 1.25
# KB-sca against JAX (tests/test_torch_hill_sca.py): sums in another order,
# and a pixel at the cost quantile may fall on the other side of it
SCA_RTOL, SCA_ATOL = 1e-4, 1e-5
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
    names.update({f"ILi{f}ELi{w}EE": f"<{FILTERS[f]}, weighted={wt}>"
                  for f in range(4) for w, wt in enumerate(WEIGHTS)})
    names.update({f"ILi{k}ELi{s}ELi{p}ELb{b}EE": f"<k={k}, s={s}, "
                  f"padl={p}, prologue={b}>" for k in (3, 5) for s in (1, 2)
                  for p in range(3) for b in (0, 1)})
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?"
                      r"(wgmma_kernel|direct_kernel|fma_kernel|ws_kernel|"
                      r"recip_kernel|mbconv_dw_kernel|gdfn_gate_kernel)"
                      r"(I\w+?EE)?", line)
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


def graph_output(fn, x: torch.Tensor) -> torch.Tensor:
    """The output of ``fn(x)`` captured once in a CUDA graph and replayed
    (after a warm-up on a side stream, as ``graph_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x)
    graph.replay()
    torch.cuda.synchronize()
    got = out.clone()
    del graph
    return got


def device_profile(fn, steps: int, top: int = 6) -> dict:
    """Run ``fn`` ``steps`` times under torch.profiler: host wall time,
    device busy time per step (``busy_ms``: the sum of the card's kernel
    and copy events; ``busy_union_ms``: the time at least one of them
    runs, which is less where cuDNN runs kernels on several streams at
    once), the kernels launched per step (``kernels``: device events other
    than copies and fills) and the kernels that take most of the sum.  The
    busy share is the union over the wall time; the profiler's own cost
    inflates the wall time, so it is a lower bound."""
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
    by_name, spans, kernels = {}, [], 0
    for e in prof.events():
        # kernels and copies only: a user annotation on the device (the
        # optimizer's step) spans kernels counted already, and the gaps
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / steps
            spans.append((e.time_range.start, e.time_range.end))
            kernels += not e.name.startswith(("Memcpy", "Memset"))
    busy = sum(by_name.values())
    union_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            union_us += end - start
            reach = end
        elif end > reach:
            union_us += end - reach
            reach = end
    union = union_us / 1e3 / steps
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_union_ms": union,
            "busy_share": union / wall_ms if by_name else None,
            "kernels": kernels / steps,
            "layout_ms": {pat: sum(ms for n, ms in by_name.items()
                                   if pat in n) for pat in LAYOUT_KERNELS},
            "copy_ms": {pat: sum(ms for n, ms in by_name.items()
                                 if "Memcpy" in n and pat in n)
                        for pat in ("Pageable", "Pinned")},
            "top": [[n[:70], ms, ms / busy]
                    for n, ms in sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:top]]}


def detection_path(smi_line: str) -> dict:
    """Phase 9: the trained LSBR unet_2 and the filter attacks on the
    golden images, held against the JAX package's numbers; B1's and B2's
    launches on this path."""
    from wsunet_tpu_torch.data import pipeline
    from wsunet_tpu_torch.detect import roc_stats
    from wsunet_tpu_torch.io import native
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.ws import (attack_batches, get_unet_estimator,
                                     load_pretrained_unet,
                                     parse_filter_model, predict_batch)

    gold = np.load(GOLDEN)
    run = str(gold["run"])
    pixels = gold["pixels"]                     # [set, 64, 128, 128] uint8
    sets, alphas = list(gold["sets"]), [float(a) for a in gold["alphas"]]
    n_img = pixels.shape[1]
    # the eval sweeps' batch of 8: the batches of each set in turn
    batches = [pixels[s, i:i + 8] for s in range(len(sets))
               for i in range(0, n_img, 8)]
    per = n_img // 8                            # batches a set

    def per_set(values) -> np.ndarray:
        return np.concatenate(values).reshape(len(sets), n_img)

    # 1. the trained model, through the entry point, on each conv route
    lsbr = REPO / "weights" / "unet" / "LSBR"
    models = {fc: load_pretrained_unet(lsbr, run, fast_conv=fc)
              for fc in (False, True)}
    config = models[False][1]
    n_params = sum(p.numel() for p in models[False][0].parameters())
    print(f"trained {config['network']} {run}: {n_params:,} parameters, "
          f"on {next(models[False][0].parameters()).device}")
    check(n_params == 1_861_697, f"trained unet_2 has {n_params} parameters")

    # every B1 launch of this phase's forwards is held against B1's plain
    # version in f32 on the same activations, at phase 5's bounds
    b1_calls = []
    launch = fused_reflect_conv._launch
    root = REPO / "build" / "smoke_p128"
    shutil.rmtree(root, ignore_errors=True)
    names = [f"images/{i:02d}.npy" for i in range(n_img)]
    bad = 2
    keep = np.arange(n_img) != bad
    fused_reflect_conv._launch = checking_b1(b1_calls, "the trained unet_2")
    try:
        # 2. the card against JAX: f32 U-Net on both routes
        beta, l1 = {}, {}
        b1_launches = 0
        for fc in (False, True):
            fused_reflect_conv.reset_launches()
            out = [predict_batch(models[fc][0], b) for b in batches]
            counts = dict(fused_reflect_conv.launches_by_variant)
            b1_launches += sum(counts.values())
            want = {"wgmma": 0, "direct": len(batches),
                    "fma": 9 * len(batches)} \
                if fc else dict.fromkeys(counts, 0)
            check(counts == want, f"B1 launches, f32 fast_conv={fc}: "
                                  f"{counts}")
            beta[fc] = per_set([o[0].cpu().numpy() for o in out])
            l1[fc] = per_set([o[1].cpu().numpy() for o in out])
            d_beta = float(np.abs(beta[fc] - gold["beta/UNet"]).max())
            d_l1 = float((np.abs(l1[fc] - gold["l1"]) / gold["l1"]).max())
            print(f"trained unet_2 f32, fast_conv={fc}, {len(batches)} "
                  f"batches of 8x128x128 against JAX: max |d beta| "
                  f"{d_beta:.3e} (<= 1e-5), max rel d l1 {d_l1:.3e} "
                  f"(<= 1e-4); B1 launches {json.dumps(counts)}")
            check(d_beta <= 1e-5 and d_l1 <= 1e-4,
                  f"trained unet_2 f32 fast_conv={fc} != JAX")
        model16, _ = load_pretrained_unet(lsbr, run,
                                          compute_dtype=torch.bfloat16,
                                          fast_conv=True)
        fused_reflect_conv.reset_launches()
        out = [predict_batch(model16, b) for b in batches]
        counts = dict(fused_reflect_conv.launches_by_variant)
        b1_launches += sum(counts.values())
        check(counts == {"wgmma": 9 * len(batches), "direct": len(batches),
                         "fma": 0}, f"B1 launches, bf16: {counts}")
        b16 = per_set([o[0].cpu().numpy() for o in out])
        l16 = per_set([o[1].cpu().numpy() for o in out])
        del model16
        # the U-Net estimator of ws-eval --models UNet, through B1 and
        # through cuDNN
        est = {}
        for fc in (False, True):
            predictor = get_unet_estimator(lsbr, run, fast_conv=fc)
            fused_reflect_conv.reset_launches()
            est[fc] = per_set([attack_batches(
                batches[s * per:(s + 1) * per], pixel_estimator=predictor)
                for s in range(len(sets))])
            n = fused_reflect_conv.launches
            b1_launches += n
            check(n == (len(UNET2_CONVS) * len(batches) if fc else 0),
                  f"U-Net estimator fast_conv={fc}: {n} B1 launches")
        d_est = float(np.abs(est[True] - est[False]).max())
        # each route is f32 with sums in its own order, as against JAX
        print(f"ws-eval's U-Net estimator (get_unet_estimator, "
              f"attack_batches), fast_conv=True against False on the card: "
              f"max |d beta| {d_est:.3e} (<= 2e-5)")
        check(d_est <= 2e-5, "U-Net estimator on B1 != on cuDNN")

        # the catalog pipeline on the card, through image files: the
        # covers as .npy files (the card has no PNG decoder), one corrupt;
        # the U-Net sweep twice, the second from the device cache
        (root / "images").mkdir(parents=True)
        for nm, img in zip(names, pixels[0]):
            np.save(root / nm, img)
        (root / names[bad]).write_bytes(b"not an array")
        pipeline.clear_decode_cache()
        fused_reflect_conv.reset_launches()
        sweeps = [pipeline.sweep_batches(
            root, names, lambda px: predict_batch(models[True][0], px), 8,
            device_cache=True, reader=np.load) for _ in range(2)]
        n = fused_reflect_conv.launches
        b1_launches += n
        check(n == 2 * per * len(UNET2_CONVS),
              f"catalog U-Net sweeps: {n} B1 launches")
        cached = list(pipeline._DEVICE_CACHE.values())
        check(len(cached) == per - 1 and
              all(t.is_cuda for t, _ in cached),
              f"device cache holds {len(cached)} batches, not {per - 1}")
        check(np.array_equal(sweeps[0], sweeps[1], equal_nan=True),
              "second U-Net sweep (device cache) != the first")
        passes = list(pipeline.iterate_batches(
            root, names, 8, reader=np.load, cache=True, device_cache=True))
        for i, batch in enumerate(passes):
            want = pixels[0, 8 * i:8 * i + 8].copy()
            if i == bad // 8:
                check(isinstance(batch.pixels, np.ndarray) and
                      not batch.mask[bad % 8] and batch.mask.sum() == 7,
                      "the batch with the corrupt file was cached")
                want[bad % 8] = 0
                got = batch.pixels
            else:
                check(isinstance(batch.pixels, torch.Tensor) and
                      batch.pixels.is_cuda and batch.mask.all(),
                      f"batch {i} did not come from the device cache")
                got = batch.pixels.cpu().numpy()
            check(np.array_equal(got, want),
                  f"catalog batch {i} != the golden pixels")
    finally:
        fused_reflect_conv._launch = launch
    ub, ul = sweeps[0][:, 0], sweeps[0][:, 1]
    d_beta = float(np.abs(ub[keep] - gold["beta/UNet"][0][keep]).max())
    d_l1 = float((np.abs(ul[keep] - gold["l1"][0][keep]) /
                  gold["l1"][0][keep]).max())
    print(f"catalog U-Net sweep on B1 (sweep_batches, {n_img} covers as "
          f"files, one corrupt, twice; the second pass from "
          f"{len(cached)} device-cached batches): NaN row for the corrupt "
          f"file; against JAX max |d beta| {d_beta:.3e} (<= 1e-5), max "
          f"rel d l1 {d_l1:.3e} (<= 1e-4)")
    check(np.isnan(sweeps[0][bad]).all() and
          np.isfinite(sweeps[0][keep]).all(),
          "catalog U-Net sweep: NaN rows wrong")
    check(d_beta <= 1e-5 and d_l1 <= 1e-4, "catalog U-Net sweep != JAX")
    by_dtype = {dt: [e for d, e in b1_calls if d == dt]
                for dt in (torch.float32, torch.bfloat16)}
    print(f"B1 = plain on every launch of the trained unet_2 forwards: "
          f"{len(by_dtype[torch.float32])} f32 launches, max |err| "
          f"{max(by_dtype[torch.float32]):.3e} (rtol 1e-4, atol 1e-4); "
          f"{len(by_dtype[torch.bfloat16])} bf16 launches, max |err| "
          f"{max(by_dtype[torch.bfloat16]):.3e} (1 bf16 ulp + 1e-4)")
    check(len(b1_calls) == b1_launches, "a B1 launch escaped the check")
    d16 = float(np.abs(b16 - beta[False]).max())
    dl16 = float(np.abs(l16 - l1[False]).max())
    # a model-level sanity check (each B1 call is held above): bf16 rounds
    # the sigmoid output to 8 bits (about one grey level near 255), so
    # beta_hat moves by more on trained weights at 128x128 than on phase
    # 4's seeded 512x512 image: the bound is the JAX package's own bf16
    # against its f32 on these images (l1: phase 4's 0.5)
    jax_d16 = float(np.abs(gold["bf16/beta"] - gold["beta/UNet"]).max())
    jax_dl16 = float(np.abs(gold["bf16/l1"] - gold["l1"]).max())
    print(f"trained unet_2 bf16, fast_conv=True, against the card's f32: "
          f"max |d beta| {d16:.3e}, max |d l1| {dl16:.3e}; the JAX "
          f"package's bf16 against its f32 on the same images: "
          f"{jax_d16:.3e}, {jax_dl16:.3e}; B1 launches {json.dumps(counts)}")
    check(np.all(np.isfinite(b16)) and d16 <= jax_d16 and dl16 < 0.5,
          "trained unet_2 bf16 further from f32 than JAX's bf16")

    # the filter attacks: KB and KB-w on B2 (one launch a batch), KB-sca on
    # the plain path
    scores = {"UNet": beta[False]}
    fused_ws.reset_launches()
    for det in ("KB", "KB-w"):
        kname, weighted, _ = parse_filter_model(det)
        before = fused_ws.launches
        scores[det] = per_set([attack_batches(
            batches[s * per:(s + 1) * per], kernel_name=kname,
            weighted=weighted) for s in range(len(sets))])
        check(fused_ws.launches - before == len(batches),
              f"{det}: B2 launched {fused_ws.launches - before} times for "
              f"{len(batches)} batches")
    before = fused_ws.launches
    scores["KB-sca"] = per_set([attack_batches(
        batches[s * per:(s + 1) * per], kernel_name="KB", sca=True)
        for s in range(len(sets))])
    check(fused_ws.launches == before, "B2 ran on the -sca path")
    # the same files through B2, one launch a batch
    before = fused_ws.launches
    kb_files = pipeline.sweep_batches(
        root, names, lambda px: (torch.from_numpy(attack_batches(
            [px], kernel_name="KB")),), 8, reader=np.load).reshape(-1)
    check(fused_ws.launches - before == per,
          f"catalog KB sweep: {fused_ws.launches - before} B2 launches")
    check(np.isnan(kb_files[bad]) and
          np.allclose(kb_files[keep], gold["beta/KB"][0][keep], rtol=RTOL,
                      atol=ATOL),
          "catalog KB sweep != JAX, or no NaN row for the corrupt file")
    print(f"catalog KB sweep on B2 ({per} batches from files, one corrupt): "
          "NaN row for the corrupt file, the rest within rtol 1e-4, "
          "atol 1e-6 of JAX")
    pipeline.clear_decode_cache()
    shutil.rmtree(root)
    b2_launches = fused_ws.launches
    for det, (rtol, atol) in (("KB", (RTOL, ATOL)), ("KB-w", (RTOL, ATOL)),
                              ("KB-sca", (SCA_RTOL, SCA_ATOL))):
        want = gold[f"beta/{det}"]
        err = float(np.abs(scores[det] - want).max())
        print(f"{det} on the card against JAX: max |err| {err:.3e} "
              f"(rtol {rtol}, atol {atol})")
        check(np.allclose(scores[det], want, rtol=rtol, atol=atol),
              f"{det}: card != JAX, max |err| {err}")

    # 3. detection statistics against JAX's
    stats = list(gold["stats"])
    bounds = {"auc": 1 / n_img ** 2, "wauc": 1 / n_img ** 2,
              "p_e": 1 / n_img, "pmd_5fp": 1 / n_img}
    table = []
    for a, alpha in enumerate(alphas):
        y = np.r_[np.zeros(n_img), np.full(n_img, alpha / 2)]
        for d, det in enumerate(gold["detectors"]):
            det = str(det)
            s = sets.index(str(alpha))
            got = roc_stats(np.clip(np.r_[scores[det][0], scores[det][s]],
                                    0, None), y)
            row = {"alpha": alpha, "detector": det}
            for k, key in enumerate(stats):
                want = float(gold["roc"][a, d, k])
                row[key] = float(got[key])
                row[key + "_jax"] = want
                if key in bounds:
                    check(abs(row[key] - want) <= bounds[key] + 1e-12,
                          f"{det} alpha {alpha}: {key} {row[key]} against "
                          f"JAX {want} (bound {bounds[key]})")
            table.append(row)
    print(f"detection on the card ({smi_line}), 64 covers + 64 LSBr stego "
          "of data_ablation/p128 per alpha, card (JAX): " + "; ".join(
              f"{r['detector']} a={r['alpha']}: AUC {r['auc']:.6f} "
              f"({r['auc_jax']:.6f}) P_E {r['p_e']:.6f} ({r['p_e_jax']:.6f}) "
              f"wAUC {r['wauc']:.6f} ({r['wauc_jax']:.6f}) PMD5FP "
              f"{r['pmd_5fp']:.6f} ({r['pmd_5fp_jax']:.6f})" for r in table))
    print("detection: every AUC and wAUC within 1/4096 of JAX's, P_E and "
          "P_MD@5%FP within 1/64")

    # 4. the native PNG decoder (host I/O)
    if native.available():
        paths = [str(REPO / "data_ablation" / "p128" / str(n))
                 for n in gold["names"]]
        decoded = native.decode_gray_batch(paths, threads=8)
        check(decoded is not None and
              np.array_equal(np.stack(decoded), pixels[0]),
              "native decoder != the golden covers")
        print(f"native decoder: built ({native.library_path().name}); "
              f"{len(paths)} p128 PNGs bitwise equal to the golden covers")
    else:
        first = (native.build_error() or "no error text").splitlines()[0]
        print(f"native decoder: unavailable ({first})")
    return {"b1_launches": b1_launches, "b2_launches": b2_launches,
            "table": table, "scores": scores, "est_b1": est[True],
            "unet_b1": (beta[True], l1[True]), "sweep": sweeps[0]}


def b0_macs(model, size: int) -> dict:
    """Multiply-accumulates of one B0 forward on a size x size image,
    counted from the layer shapes (forward hooks on every conv and the
    classifier of a one-image forward on the modules' composition: B3
    calls no depthwise conv module), by kind: the stem, the 1x1 expand,
    project and head convs, the depthwise convs, squeeze-excite and the
    classifier."""
    from wsunet_tpu_torch.models.b0 import _MBConv, _SqueezeExcite

    macs = {"stem": 0, "1x1": 0, "depthwise": 0, "se": 0, "classifier": 0}
    se = {id(m) for blk in model.modules() if isinstance(blk, _SqueezeExcite)
          for m in blk.modules()}
    hooks = []

    def count(mod, inputs, out):
        if isinstance(mod, torch.nn.Linear):
            macs["classifier"] += mod.in_features * mod.out_features
            return
        k = mod.in_channels // mod.groups * mod.kernel_size[0] * \
            mod.kernel_size[1]
        n = out[0].numel() * k
        kind = ("se" if id(mod) in se else "stem" if mod is model.conv_stem
                else "depthwise" if mod.groups > 1 else "1x1")
        macs[kind] += n

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            hooks.append(mod.register_forward_hook(count))
    dev = next(model.parameters()).device
    takes_b3 = _MBConv.takes_b3
    _MBConv.takes_b3 = lambda self, h: False
    try:
        with torch.no_grad():
            model(torch.zeros(1, model.conv_stem.in_channels -
                              int(model.parity_features), size, size,
                              device=dev))
    finally:
        _MBConv.takes_b3 = takes_b3
        for h in hooks:
            h.remove()
    return macs


def b0_path(smi_line: str) -> dict:
    """Phase 10: the B0 detection path.  (a) both exported LSBR B0 runs on
    the golden images against JAX (P(stego), f32 and bf16, and the ROC
    statistics of both ``roc --b0`` labels); (b) the name-based catalog
    sweep from ``.npy`` files, one corrupt; (c) OLS fitted on the card
    against JAX (taps and beta_hat; gray and color4), off B2; (d) both
    configurations at full width, 512x512, B=8 and B=32, f32 and bf16."""
    from wsunet_tpu_torch.data import pipeline
    from wsunet_tpu_torch.detect import (infer_b0, load_pretrained_b0,
                                         roc_stats)
    from wsunet_tpu_torch.detect.b0_eval import get_b0_detector, score_sweep
    from wsunet_tpu_torch.ops import fused_ws, ols, ws_attack
    from wsunet_tpu_torch.ws import attack_batches

    gold = np.load(GOLDEN_B0)
    gold0 = np.load(GOLDEN)
    check(np.array_equal(gold["names"], gold0["names"]),
          "p128_b0.npz and p128_lsbr.npz hold different images")
    pixels = gold0["pixels"]                     # [set, 64, 128, 128]
    sets, alphas = list(gold["sets"]), [float(a) for a in gold["alphas"]]
    n_img = pixels.shape[1]
    batches = [pixels[s, i:i + 8] for s in range(len(sets))
               for i in range(0, n_img, 8)]
    b0_dir = REPO / "weights" / "b0" / "LSBR"

    def per_set(values) -> np.ndarray:
        return torch.cat(values).cpu().numpy().reshape(len(sets), n_img)

    # (a) the trained runs against JAX, f32 with TF32 off
    probs, models = {}, {}
    for run, label in zip(gold["runs"], gold["labels"]):
        label = str(label)
        model, config = load_pretrained_b0(b0_dir, str(run))
        ref = bool(config["lsbr_reference"])
        models[label] = (model, config)
        probs[label] = per_set([infer_b0(model, b, use_lsbr_reference=ref)
                                for b in batches])
        err = float(np.abs(probs[label] - gold[f"prob/{label}"]).max())
        n_params = sum(p.numel() for p in model.parameters())
        print(f"trained B0 {label} ({run}; {n_params:,} parameters, "
              f"no_stem_stride={config['no_stem_stride']}, lsbr_reference="
              f"{ref}, parity_features={config['parity_features']}), f32, "
              f"{len(batches)} batches of 8x128x128 against JAX: max |d "
              f"P(stego)| {err:.3e} (bound {B0_ATOL}; within 1e-5: "
              f"{err <= 1e-5})")
        check(err <= B0_ATOL, f"trained B0 {label} f32 != JAX")
        # bf16 on the covers, against the card's f32, within 1.25 times
        # the JAX package's own bf16-to-f32 distance on the same images:
        # bf16 loses the LSB signal in both packages alike, and one image
        # sets the maximum (CPU: 9.373e-2 against JAX's 9.346e-2)
        model16, _ = load_pretrained_b0(b0_dir, str(run),
                                        compute_dtype=torch.bfloat16)
        p16 = torch.cat([infer_b0(model16, b, use_lsbr_reference=ref)
                         for b in batches[:n_img // 8]]).cpu().numpy()
        del model16
        d16 = float(np.abs(p16 - probs[label][0]).max())
        jax_d16 = float(np.abs(gold[f"prob_bf16/{label}"] -
                               gold[f"prob/{label}"][0]).max())
        print(f"trained B0 {label} bf16 against the card's f32 on the "
              f"{n_img} covers: max |d P| {d16:.3e}; the JAX package's "
              f"bf16 against its f32: {jax_d16:.3e} (bound {B0_BF16_SLACK} "
              "times that)")
        check(np.isfinite(p16).all() and d16 <= B0_BF16_SLACK * jax_d16,
              f"trained B0 {label} bf16 further from f32 than JAX's bf16")

    # (c) OLS on the card: the normal equations in float64 on the device
    covers = torch.from_numpy(pixels[0]).cuda()
    taps = ols.fit_ols(covers)
    d_taps = float(np.abs(taps - gold["ols/taps"]).max())
    kernel = ols.ols_kernel2d(covers)[::-1, ::-1]
    before = fused_ws.launches
    probs["OLS"] = attack_batches(batches, pixel_kernel=kernel).reshape(
        len(sets), n_img)
    check(fused_ws.launches == before, "OLS ran on B2")
    d_beta = float(np.abs(probs["OLS"] - gold["beta/OLS"]).max())
    channels = tuple(int(c) for c in gold["color/channels"])
    x4 = torch.from_numpy(gold["color/pixels"]).cuda().permute(0, 1, 4, 2, 3)
    kernels = ols.ols_color_kernels(x4[0], channels)
    d_ctaps = float(np.abs(ols.fit_ols_color(x4[0], channels) -
                           gold["color/taps"]).max())
    cbeta = torch.stack([ws_attack(
        x[:, channels[-1]],
        pixel_estimator=lambda _, x=x: ols.ols_color_predict(x.float(),
                                                             kernels))
        for x in x4]).cpu().numpy()
    d_cbeta = float(np.abs(cbeta - gold["color/beta"]).max())
    print(f"OLS on the card (float64 normal equations, exact for integer "
          f"pixels) against JAX's f32 sums: gray taps on {n_img} covers "
          f"max |d| {d_taps:.3e} (<= 2e-3), beta_hat over "
          f"{len(batches)} batches {d_beta:.3e} (<= 2e-4); color4 "
          f"{channels} taps {d_ctaps:.3e} (<= 1e-2), beta_hat {d_cbeta:.3e} "
          "(<= 1e-3); no B2 launch")
    check(d_taps <= 2e-3 and d_beta <= 2e-4 and d_ctaps <= 1e-2 and
          d_cbeta <= 1e-3, "OLS on the card != JAX")

    # the detection statistics of both B0 labels (label alpha) at phase 9's
    # bounds, and of OLS (clipped beta_hat, label alpha / 2) within one
    # image's weight: JAX's f32 normal equations move its taps, and an
    # image may cross one of the grid's thresholds
    stats = list(gold["stats"])
    b0_bounds = {"auc": 1 / n_img ** 2, "wauc": 1 / n_img ** 2,
                 "p_e": 1 / n_img, "pmd_5fp": 1 / n_img}
    ols_bounds = dict.fromkeys(b0_bounds, 1 / n_img)
    table = []
    for a, alpha in enumerate(alphas):
        s = sets.index(str(alpha))
        for d, det in enumerate(gold["detectors"]):
            det = str(det)
            score = np.r_[probs[det][0], probs[det][s]]
            if det == "OLS":
                got = roc_stats(np.clip(score, 0, None),
                                np.r_[np.zeros(n_img), np.full(n_img,
                                                               alpha / 2)])
            else:
                got = roc_stats(score, np.r_[np.zeros(n_img),
                                             np.full(n_img, alpha)])
            row = {"alpha": alpha, "detector": det}
            bounds = ols_bounds if det == "OLS" else b0_bounds
            for k, key in enumerate(stats):
                want = float(gold["roc"][a, d, k])
                row[key], row[key + "_jax"] = float(got[key]), want
                if key in bounds:
                    check(abs(row[key] - want) <= bounds[key] + 1e-12,
                          f"{det} alpha {alpha}: {key} {row[key]} against "
                          f"JAX {want} (bound {bounds[key]})")
            table.append(row)
    print(f"B0 / OLS detection on the card ({smi_line}), 64 covers + 64 "
          "LSBr stego of data_ablation/p128 per alpha, card (JAX): " +
          "; ".join(f"{r['detector']} a={r['alpha']}: AUC {r['auc']:.6f} "
                    f"({r['auc_jax']:.6f}) P_E {r['p_e']:.6f} "
                    f"({r['p_e_jax']:.6f}) wAUC {r['wauc']:.6f} "
                    f"({r['wauc_jax']:.6f}) PMD5FP {r['pmd_5fp']:.6f} "
                    f"({r['pmd_5fp_jax']:.6f})" for r in table))
    print("B0 / OLS detection: B0's AUC and wAUC within 1/4096 of JAX's, "
          "P_E and P_MD@5%FP within 1/64; OLS's four within 1/64")

    # (b) the catalog sweep through image names, from .npy files
    root = REPO / "build" / "smoke_b0"
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    names = [f"images/{i:02d}.npy" for i in range(n_img)]
    for nm, img in zip(names, pixels[0]):
        np.save(root / nm, img)
    bad = 5
    (root / names[bad]).write_bytes(b"not an array")
    keep = np.arange(n_img) != bad
    pipeline.clear_decode_cache()
    for run, label in zip(gold["runs"], gold["labels"]):
        label = str(label)
        detect = get_b0_detector(b0_dir, str(run), lsbr_reference=bool(
            models[label][1]["lsbr_reference"]))
        got = score_sweep(root, names, detect, 8, reader=np.load)
        err = float(np.abs(got[keep] - gold[f"prob/{label}"][0][keep]).max())
        check(np.isnan(got[bad]) and np.isfinite(got[keep]).all() and
              err <= B0_ATOL, f"catalog B0 sweep {label}: NaN rows wrong "
                              f"or != JAX ({err})")
        print(f"catalog B0 sweep {label} (score_sweep over {n_img} .npy "
              f"files, one corrupt): NaN row for the corrupt file; the "
              f"rest max |d P| {err:.3e} from JAX")
    pipeline.clear_decode_cache()
    shutil.rmtree(root)

    # (d) both configurations at full width: 512x512, the detector-eval
    # batch (8) and 32, f32 (TF32 off) and bf16
    rows = []
    x32 = torch.from_numpy(smooth_covers(32, 512, seed=21)).cuda()
    for label, (model, config) in models.items():
        ref = bool(config["lsbr_reference"])
        macs = b0_macs(model, 512)
        gmacs = sum(macs.values()) / 1e9
        for dtype in (torch.float32, torch.bfloat16):
            m = copy.deepcopy(model)
            m.compute_dtype = dtype
            peak = F32_OPS_PER_S if dtype == torch.float32 \
                else BF16_OPS_PER_S
            for B in (8, 32):
                x = x32[:B]

                def step(v, m=m):
                    return infer_b0(m, v, use_lsbr_reference=ref)

                step(x)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step(x)
                torch.cuda.synchronize()
                peak_mem = torch.cuda.max_memory_allocated()
                t0 = time.perf_counter()
                for _ in range(3):
                    step(x)
                torch.cuda.synchronize()
                host_ms = 1e3 * (time.perf_counter() - t0) / 3
                dev_ms = graph_ms(step, [x], reps=3, iters=2)
                row = {"detector": label, "dtype": str(dtype)[6:], "B": B,
                       "img_per_s": B * 1e3 / host_ms, "host_ms": host_ms,
                       "device_ms": dev_ms,
                       "device_img_per_s": B * 1e3 / dev_ms,
                       "peak_mem_gib": peak_mem / 2 ** 30,
                       "gmacs_per_img": gmacs,
                       "tflops": 2 * gmacs * B / dev_ms,
                       "peak_share": 2e9 * gmacs * B / (dev_ms * 1e-3) / peak}
                if B == 32:
                    prof = device_profile(lambda: step(x), 2, top=8)
                    row["busy_share"] = prof["busy_share"]
                    row["top"] = prof["top"] if prof["busy_share"] \
                        is not None else "not measured"
                print(f"B0 full width ({smi_line}): " + json.dumps(row))
                rows.append(row)
            del m
        print(f"B0 {label} MACs per 512x512 image by kind (from the layer "
              f"shapes): " + json.dumps(macs))
    del x32
    torch.cuda.empty_cache()
    print("B0 img_per_s: host clock over 3 synchronised steps (infer_b0 "
          "from uint8 on the card: /255, the reference plane, "
          "normalisation, the model, softmax); device_ms: CUDA-graph "
          "replay; peak_mem: torch.cuda.max_memory_allocated over one "
          "step; tflops = 2 * MACs / device time, peak_share against "
          "67e12 f32 / 989e12 bf16 (H100 SXM data sheet)")
    return {"table": table, "full_width": rows}


def _grads_flax(model) -> dict:
    """A model's gradients in the Flax params layout, f32 numpy."""
    from wsunet_tpu_torch.models import flax_params_from_unet_state_dict
    from wsunet_tpu_torch.train.checkpoint import flatten_tree

    return flatten_tree(flax_params_from_unet_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))


def _rel_grad_err(got: dict, want: dict) -> float:
    """The largest max|got - want| / max|want| over the tensors of
    ``want``."""
    return max(float(np.abs(got[k] - want[k]).max() /
                     max(float(np.abs(want[k]).max()), 1e-30))
               for k in want)


def top_ops(fn, top: int = 3) -> list:
    """The ``top`` PyTorch operators of one call of ``fn`` by the device
    time of their own kernels, with their input shapes (torch.profiler,
    grouped by input shape): [name, shapes, ms]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(a):
        return getattr(a, "self_device_time_total", None) or getattr(
            a, "self_cuda_time_total", 0.0)

    rows = [a for a in prof.key_averages(group_by_input_shape=True)
            if a.key.startswith("aten::")]
    rows.sort(key=lambda a: -device_us(a))
    return [[a.key, str(a.input_shapes)[:80], device_us(a) / 1e3]
            for a in rows[:top]]


_LSBR_RECIPE = dict(crop=512, batch_size=4, augment=True,
                    stego_method="LSBR", alpha=0.4, loss="l1ws",
                    loss_lambda=0.25, weighted_loss=True,
                    lr_schedule="cosine", learning_rate=2e-5, drop_rate=None,
                    compute_dtype="float32", num_epochs=50)
# phase 11 (b): both committed recipes (weights/unet/LSBR/260819071329-*
# and the dropout run's config), LSBR again in bf16 and with HILLr
RECIPES = {
    "LSBR f32": _LSBR_RECIPE,
    "LSBR bf16": {**_LSBR_RECIPE, "compute_dtype": "bfloat16"},
    "LSBR HILLr f32": {**_LSBR_RECIPE, "stego_method": "HILLR"},
    "dropout f32": dict(crop=320, batch_size=12, augment=False,
                        stego_method=None, alpha=None, loss="l1",
                        loss_lambda=None, weighted_loss=False,
                        lr_schedule=None, learning_rate=1e-4, drop_rate=0.1,
                        compute_dtype="float32", num_epochs=50),
}


def time_recipe(label: str, r: dict, smi_line: str) -> dict:
    """Train seeded ``unet_2`` in recipe ``r`` on 512x512 seeded covers on
    the card: 2 warm-up steps, 5 timed (step ms by CUDA events, img/s by
    host clock, peak memory), then one profiled step (busy share, top
    kernels and operators).  Prints and returns the row."""
    from wsunet_tpu_torch.models import get_model, init_unet
    from wsunet_tpu_torch.train import get_loss
    from wsunet_tpu_torch.train.train_unet import _make_step, make_optimizer

    dev = torch.device("cuda")
    B = r["batch_size"]
    model = init_unet(get_model(
        "unet_2", drop_rate=r["drop_rate"],
        compute_dtype=getattr(torch, r["compute_dtype"])), 0).to(dev)
    loss_fn = get_loss(r["loss"], per_image=True,
                       loss_lambda=r["loss_lambda"]
                       if r["weighted_loss"] else None)
    opt, sch = make_optimizer(r, 100, model.parameters())
    step = _make_step(model, loss_fn, opt, sch, r["stego_method"],
                      r["alpha"], crop=r["crop"], augment=r["augment"])[0]
    x = torch.from_numpy(smooth_covers(B, 512, seed=41)).to(dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        step(x, mask, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = [float(step(x, mask, gen)) for _ in range(n)]
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{label}: a loss is not finite")
    prof = device_profile(lambda: step(x, mask, gen), 1, top=6)
    ops = top_ops(lambda: step(x, mask, gen))
    row = {"recipe": label, "B": B, "crop": r["crop"],
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "step_ms": start.elapsed_time(end) / n,
           "img_per_s": B * n / host_s,
           "peak_mem_gib": peak_mem / 2 ** 30,
           "busy_share": prof["busy_share"],
           "kernels_per_step": prof["kernels"] if prof["busy_share"]
           is not None else "not measured",
           "top": prof["top"] if prof["busy_share"] is not None
           else "not measured", "top_ops": ops, "loss": losses[-1]}
    print(f"training (b), full width ({smi_line}): " + json.dumps(row))
    del model, opt, sch, step, x
    torch.cuda.empty_cache()
    return row


def training_path(smi_line: str) -> dict:
    """Phase 11: the U-Net trainer on the card.  (a) the step held to the
    JAX trainer's golden numbers (``weights/golden/p128_train_step.npz``:
    JAX's draws, loss, gradients, and three AdamW steps under the cosine
    schedule); (b) both committed recipes at full width (``unet_2``,
    512x512 seeded covers): LSBR (B=4, f32, TF32 off, augment, alpha 0.4,
    weighted l1ws, cosine), again in bf16 and with HILLr, and dropout
    (crop 320, B=12, UniformDropout 0.1, l1, no stego): step ms by CUDA
    events, img/s by host clock, peak memory, busy share and top kernels
    of one profiled step; (c) the card against the CPU on the same draws
    (loss and gradients), and HILLr bitwise at 512x512; (d) ``train_names``
    on ``.npy`` covers for 2 epochs of 2 steps, its run loaded with
    ``load_pretrained_unet`` and served through ``predict_batch``.  B1 and
    B2 are off this path (JAX trains on XLA convs and the plain WS loss):
    the phase checks that neither launches."""
    from wsunet_tpu_torch.data.simulate import hillr_simulate
    from wsunet_tpu_torch.models import (get_model, init_unet,
                                         unet_state_dict_from_flax)
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.train import get_loss, load_checkpoint, load_params
    from wsunet_tpu_torch.train.checkpoint import flatten_tree
    from wsunet_tpu_torch.train.train_unet import (Sampler, _make_step,
                                                   make_optimizer,
                                                   train_names)
    from wsunet_tpu_torch.models import flax_params_from_unet_state_dict
    from wsunet_tpu_torch.ws import load_pretrained_unet, predict_batch

    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    out = {}

    # (a) the golden step: JAX's draws on the committed LSBR weights
    z = np.load(GOLDEN_TRAIN)
    cfg = json.loads(str(z["config"]))
    run_dir = REPO / "weights" / "unet" / "LSBR" / str(z["run"])
    params = unet_state_dict_from_flax(load_params(run_dir)[0])
    fn = get_loss(cfg["loss"], per_image=True,
                  loss_lambda=cfg["loss_lambda"])

    def golden_model(device):
        m = get_model(cfg["network"])
        m.load_state_dict(params)
        return m.to(device)

    def draws(s, device):
        p = f"draws/{s}/"
        d = {k[len(p):]: torch.from_numpy(z[k]) for k in z.files
             if k.startswith(p)}
        return {k: (v.long() if v.dtype == torch.int32 else v).to(device)
                for k, v in d.items()}

    def sampler(m):
        return Sampler(m, fn, cfg["stego_method"], cfg["alpha"],
                       crop=cfg["crop"], augment=cfg["augment"],
                       cover_fraction=cfg["cover_fraction"])

    def one_step(device):
        m = golden_model(device).train()
        loss = sampler(m).loss(torch.from_numpy(z["pixels"][0]).to(device),
                               torch.from_numpy(z["mask"][0]).to(device),
                               draws(0, device))[0]
        loss.backward()
        return float(loss), _grads_flax(m)

    loss_card, g_card = one_step(dev)
    full = {k[len("grad/"):]: z[k] for k in z.files if k.startswith("grad/")}
    d_loss = abs(loss_card / float(z["loss"]) - 1)
    d_grad = _rel_grad_err(g_card, full)
    d_norm = max(abs(float(np.linalg.norm(g_card[k])) /
                     float(z[f"grad_norm/{k}"]) - 1) for k in g_card)
    check(d_loss <= 1e-4, f"golden step loss: rel {d_loss:.3e} > 1e-4")
    check(d_grad <= 1e-3, f"golden step gradients: {d_grad:.3e} > 1e-3")
    check(d_norm <= 1e-3, f"golden gradient norms: rel {d_norm:.3e}")
    m = golden_model(dev)
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"], m.parameters())
    train_step = _make_step(m, fn, opt, sch, cfg["stego_method"],
                            cfg["alpha"], crop=cfg["crop"],
                            augment=cfg["augment"],
                            cover_fraction=cfg["cover_fraction"])[0]
    losses = [float(train_step(torch.from_numpy(z["pixels"][s]).to(dev),
                               torch.from_numpy(z["mask"][s]).to(dev),
                               draws=draws(s, dev)))
              for s in range(len(z["adamw_loss"]))]
    d_adam = float(np.max(np.abs(np.array(losses) / z["adamw_loss"] - 1)))
    pn = flatten_tree(flax_params_from_unet_state_dict(m.state_dict()))
    d_pnorm = max(abs(float(np.linalg.norm(pn[k])) /
                      float(z[f"param_norm/{k}"]) - 1) for k in pn)
    check(d_adam <= 1e-4, f"golden AdamW losses: rel {d_adam:.3e}")
    check(d_pnorm <= 1e-5, f"golden parameter norms: rel {d_pnorm:.3e}")
    out["golden"] = {"loss_rel": d_loss, "grad_rel": d_grad,
                     "grad_norm_rel": d_norm, "adamw_loss_rel": d_adam,
                     "param_norm_rel": d_pnorm}
    print(f"training (a), golden step against JAX ({smi_line}): loss "
          f"{loss_card:.8f} (JAX {float(z['loss']):.8f}, rel {d_loss:.3e} "
          f"<= 1e-4); gradients max|d|/max|g| {d_grad:.3e} (<= 1e-3), "
          f"norms rel {d_norm:.3e}; 3 AdamW steps: losses rel {d_adam:.3e} "
          f"(<= 1e-4), parameter norms rel {d_pnorm:.3e} (<= 1e-5)")

    # (c) the card against the CPU on the same draws: the golden step, and
    # the dropout recipe's step (crop 48, keep masks) on seeded unet_2
    loss_cpu, g_cpu = one_step(cpu)
    c_loss = abs(loss_card / loss_cpu - 1)
    c_grad = _rel_grad_err(g_card, g_cpu)
    drop = init_unet(get_model("unet_2", drop_rate=0.1), seed=3)
    l1 = get_loss("l1", per_image=True)
    covers = torch.from_numpy(smooth_covers(4, 128, seed=31))
    mask = torch.ones(4, dtype=torch.bool)
    res = []                                     # (loss, grads): CPU, card
    d_cpu = Sampler(drop, l1, None, None, crop=48, augment=True).draw(
        covers.shape, torch.Generator().manual_seed(0))
    for device in (cpu, dev):
        m = copy.deepcopy(drop).to(device).train()
        loss = Sampler(m, l1, None, None, crop=48, augment=True).loss(
            covers.to(device), mask.to(device),
            {k: v.to(device) for k, v in d_cpu.items()})[0]
        loss.backward()
        res.append((float(loss), _grads_flax(m)))
    cd_loss = abs(res[1][0] / res[0][0] - 1)
    cd_grad = _rel_grad_err(res[1][1], res[0][1])
    check(max(c_loss, cd_loss) <= 1e-4,
          f"card vs CPU loss: rel {c_loss:.3e} / {cd_loss:.3e} > 1e-4")
    check(max(c_grad, cd_grad) <= 1e-3,
          f"card vs CPU gradients: {c_grad:.3e} / {cd_grad:.3e} > 1e-3")
    hill = smooth_covers(4, 512, seed=33)
    hill_equal = all(torch.equal(
        hillr_simulate(torch.from_numpy(hill).to(dev), a).cpu(),
        hillr_simulate(torch.from_numpy(hill), a)) for a in (0.4, 0.1))
    check(hill_equal, "HILLr on the card differs from HILLr on the CPU")
    out["card_vs_cpu"] = {"lsbr_loss_rel": c_loss, "lsbr_grad_rel": c_grad,
                          "dropout_loss_rel": cd_loss,
                          "dropout_grad_rel": cd_grad,
                          "hillr_512_bitwise": hill_equal}
    print(f"training (c), card against CPU ({smi_line}): LSBR golden step "
          f"loss rel {c_loss:.3e}, gradients {c_grad:.3e}; dropout step "
          f"(crop 48, keep masks) loss rel {cd_loss:.3e}, gradients "
          f"{cd_grad:.3e} (<= 1e-4, 1e-3); HILLr 4x512x512 at alpha 0.4 "
          f"and 0.1 bitwise equal")

    # (b) both committed recipes at full width, one timed row each
    out["full_width"] = [time_recipe(label, r, smi_line)
                         for label, r in RECIPES.items()]
    print("training step_ms: CUDA events over 5 steps after 2 warm-up "
          "steps (draws, augmentation, embedding, forward, backward, AdamW "
          "and schedule; the host reads each loss, as the trainer does); "
          "img_per_s: host clock over the same 5 steps; peak_mem: "
          "torch.cuda.max_memory_allocated over them; busy_share: device "
          "kernel time over host wall time of one profiled step")

    # (d) the loop closes: train_names on .npy covers, then serve the run
    root = REPO / "build" / "smoke_train"
    if root.exists():
        shutil.rmtree(root)
    (root / "images").mkdir(parents=True)
    pixels = z["pixels"].reshape(-1, 128, 128)
    names = []
    for i, img in enumerate(pixels):
        names.append(f"images/{i}.npy")
        np.save(root / names[-1], img)
    cfg_d = dict(network="unet_2", crop=64, batch_size=4, steps_per_epoch=2,
                 num_epochs=2, val_steps=1, augment=True, alpha=0.4,
                 weighted_loss=True, lr_schedule="cosine", seed=1)
    exp = train_names(cfg_d, root, names[:8], names[8:], root / "runs",
                      device="cuda", reader=np.load)
    model, config = load_pretrained_unet(exp.parent, exp.name,
                                         device="cuda")
    best = load_checkpoint(exp, "best")["params"]
    same = all(torch.equal(best[k].cpu(), v.cpu())
               for k, v in model.state_dict().items())
    check(same, "the served model is not the run's model/best")
    beta, l1 = predict_batch(model, pixels[:4], device="cuda")
    check(beta.shape == (4,) and bool(torch.isfinite(beta).all())
          and bool(torch.isfinite(l1).all()), "served beta_hat not finite")
    rows_csv = (exp / "log" / "scalars.csv").read_text().split()
    check(len(rows_csv) == 8, f"scalars.csv has {len(rows_csv)} rows")
    out["loop"] = {"run": exp.name, "beta_hat": beta.tolist()}
    print(f"training (d), train_names -> load_pretrained_unet -> "
          f"predict_batch: {exp.name}; beta_hat {beta.cpu().numpy()}")
    check(fused_reflect_conv.launches == 0 and fused_ws.launches == 0,
          "a TPU-kernel port launched on the training path")
    return out


def _b0_config(run: str, **over) -> dict:
    """The committed config of a B0 run (the keys the trainer takes), with
    ``over`` applied."""
    import dataclasses

    from wsunet_tpu_torch.train.checkpoint import load_config
    from wsunet_tpu_torch.train.config import B0TrainConfig

    conf = load_config(REPO / "weights" / "b0" / "LSBR" / run)
    keys = {f.name for f in dataclasses.fields(B0TrainConfig)}
    return B0TrainConfig.validate({**{k: v for k, v in conf.items()
                                      if k in keys}, **over})


def _b0_model(cfg: dict, run: str, device, dtype=None):
    """The B0 of ``cfg`` with the committed run's parameters and running
    statistics, on ``device`` (in ``dtype``, parameters included, when
    given: the float64 reference)."""
    from wsunet_tpu_torch.models import b0_state_dict_from_flax
    from wsunet_tpu_torch.train.checkpoint import load_params
    from wsunet_tpu_torch.train.train_b0 import build_model

    model = build_model(cfg)
    model.load_state_dict(b0_state_dict_from_flax(*load_params(
        REPO / "weights" / "b0" / "LSBR" / run)))
    if dtype is not None:
        model = model.to(dtype)
        model.compute_dtype = dtype
    return model.to(device)


def _b0_grads(model) -> tuple:
    """(gradients, running statistics) of a B0 in the Flax layout."""
    from wsunet_tpu_torch.models import flax_b0_params_from_state_dict
    from wsunet_tpu_torch.train.checkpoint import flatten_tree

    grads = flax_b0_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})[0]
    stats = flax_b0_params_from_state_dict(model.state_dict())[1]
    return flatten_tree(grads), flatten_tree(stats)


def time_b0_recipe(label: str, run: str, dtype: str, smi_line: str) -> dict:
    """Train the committed B0 run ``run`` in its own recipe (``freeze_bn``,
    high-pass and quadratic stem, parity features or the LSBr plane, the
    alpha mix, flips and rot90, AdamW under the cosine schedule) in
    ``dtype`` on seeded 512x512 covers, B=2 pairs: 2 warm-up steps, 5
    timed (step ms by CUDA events, img/s of the 4 images a step by host
    clock, peak memory), then one profiled step."""
    from wsunet_tpu_torch.train.train_b0 import _make_steps
    from wsunet_tpu_torch.train.train_unet import make_optimizer

    dev = torch.device("cuda")
    cfg = _b0_config(run, compute_dtype=dtype)
    B = cfg["batch_size"]
    model = _b0_model(cfg, run, dev)
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"],
                              model.parameters())
    step = _make_steps(model, opt, sch, cfg)[0]
    x = torch.from_numpy(smooth_covers(B, 512, seed=51)).to(dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        step(x, mask, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = [float(step(x, mask, gen)[0]) for _ in range(n)]
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"B0 {label}: a loss is not finite")
    prof = device_profile(lambda: step(x, mask, gen), 1, top=6)
    ops = top_ops(lambda: step(x, mask, gen))
    row = {"recipe": label, "dtype": dtype, "pairs": B, "crop": cfg["crop"],
           "step_ms": start.elapsed_time(end) / n,
           "img_per_s": 2 * B * n / host_s,
           "host_ms": 1e3 * host_s / n,
           "peak_mem_gib": peak_mem / 2 ** 30,
           "busy_share": prof["busy_share"],
           "kernels_per_step": prof["kernels"] if prof["busy_share"]
           is not None else "not measured",
           "top": prof["top"] if prof["busy_share"] is not None
           else "not measured", "top_ops": ops, "loss": losses[-1]}
    print(f"B0 training (b), full width ({smi_line}): " + json.dumps(row))
    del model, opt, sch, step, x
    torch.cuda.empty_cache()
    return row


def b0_training_path(smi_line: str) -> dict:
    """Phase 12: the B0 trainer and ``filters-eval``'s step on the card
    ((a)-(e) in the module docstring).  B1 and B2 are off this path: the
    phase checks that neither launches."""
    from wsunet_tpu_torch.models import b0_state_dict_from_flax
    from wsunet_tpu_torch.detect import infer_b0, load_pretrained_b0
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.ops.filters import NAMED_FILTERS, taps_to_kernel2d
    from wsunet_tpu_torch.train.bn_recalibrate import recalibrate_names
    from wsunet_tpu_torch.train.checkpoint import flatten_tree, load_params
    from wsunet_tpu_torch.train.train_b0 import (B0Sampler, _make_steps,
                                                 train_names)
    from wsunet_tpu_torch.train.train_unet import make_optimizer
    from wsunet_tpu_torch.ws import mae_wmae

    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    out = {}

    # (a) the golden steps: JAX's draws on the committed strided run
    z = np.load(GOLDEN_B0_TRAIN)
    run = str(z["run"])
    check(run == B0_RUNS["strided"], f"golden B0 run {run}")
    cfg = _b0_config(run, **json.loads(str(z["config"])))

    def draws(prefix, device):
        d = {k[len(prefix):]: torch.from_numpy(z[k]) for k in z.files
             if k.startswith(prefix)}
        return {k: (v.long() if v.dtype == torch.int32 else v).to(device)
                for k, v in d.items()}

    def recipe_step(device):
        m = _b0_model(cfg, run, device).eval()
        loss, logits, _ = B0Sampler(
            m, cfg["stego_method"], cfg["alpha"], crop=cfg["crop"],
            augment=cfg["augment"]).loss(
            torch.from_numpy(z["pixels"][0]).to(device),
            torch.from_numpy(z["mask"][0]).to(device),
            draws("draws/0/", device))
        loss.backward()
        return float(loss), logits.detach().cpu().numpy(), _b0_grads(m)[0]

    def live_step(dtype, jitted_inputs=False):
        m = _b0_model(cfg, run, dev, dtype).train()
        sampler = B0Sampler(
            m, cfg["stego_method"], cfg["alpha"], crop=cfg["crop"],
            augment=cfg["augment"], dropout_rate=cfg["drop_rate"])
        if jitted_inputs:
            # JAX's jitted f32 preprocessing, per pixel value: the inputs
            # its float64 step took
            lut = torch.from_numpy(z["live/preprocess_lut"]).to(dev)
            sampler.preprocess = lambda x_u8: lut[x_u8.long()][:, None]
        loss, logits, _ = sampler.loss(
            torch.from_numpy(z["pixels"][-1]).to(dev),
            torch.from_numpy(z["mask"][-1]).to(dev),
            draws("live/draws/", dev))
        loss.backward()
        return (float(loss), logits.detach().double().cpu().numpy(),
                *_b0_grads(m))

    loss_card, logits_card, g_card = recipe_step(dev)
    full = [k[len("grad/"):] for k in z.files if k.startswith("grad/")]
    d_loss = abs(loss_card / float(z["loss"]) - 1)
    d_logits = float(np.abs(logits_card - z["logits"]).max())
    d_grad = _rel_grad_err(g_card, {k: z[f"grad/{k}"] for k in full})
    d_norm = max(abs(float(np.linalg.norm(g_card[k])) /
                     float(z[f"grad_norm/{k}"]) - 1) for k in g_card)
    check(d_loss <= 1e-4, f"B0 golden step loss: rel {d_loss:.3e} > 1e-4")
    check(d_grad <= 1e-3, f"B0 golden gradients: {d_grad:.3e} > 1e-3")
    check(d_norm <= 1e-3, f"B0 golden gradient norms: rel {d_norm:.3e}")
    m = _b0_model(cfg, run, dev)
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"], m.parameters())
    train_step = _make_steps(m, opt, sch, cfg)[0]
    losses = [float(train_step(torch.from_numpy(z["pixels"][s]).to(dev),
                               torch.from_numpy(z["mask"][s]).to(dev),
                               draws=draws(f"draws/{s}/", dev))[0])
              for s in range(len(z["adamw_loss"]))]
    d_adam = float(np.max(np.abs(np.array(losses) / z["adamw_loss"] - 1)))
    check(d_adam <= 1e-4, f"B0 golden AdamW losses: rel {d_adam:.3e}")
    del m, opt, sch, train_step

    l64, _, g64, s64 = live_step(torch.float64, jitted_inputs=True)
    l32, _, g32, s32 = live_step(torch.float32)

    def live_errs(tag, loss, grads, stats):
        """(loss rel, gradients max|d|/max|g|, statistics rel) against
        JAX's ``tag`` step (``live`` f32, ``live64`` float64)."""
        want = {k[len(f"{tag}/grad/"):]: z[k] for k in z.files
                if k.startswith(f"{tag}/grad/")}
        return (abs(loss / float(z[f"{tag}/loss"]) - 1),
                _rel_grad_err(grads, want),
                max(float(np.abs(stats[k] - z[f"{tag}/stats/{k}"]).max() /
                          np.abs(z[f"{tag}/stats/{k}"]).max())
                    for k in (k[len(f"{tag}/stats/"):] for k in z.files
                              if k.startswith(f"{tag}/stats/"))))

    v = live_errs("live64", l64, g64, s64)
    f = live_errs("live", l32, g32, s32)
    f64 = live_errs("live64", l32, g32, s32)
    check(max(v) <= 1e-6,
          f"B0 live step (float64 on the card) != JAX's float64: loss "
          f"{v[0]:.3e}, gradients {v[1]:.3e}, statistics {v[2]:.3e}")
    # the live step's own f32 rounding: at 4x4 and 2x2 the deepest batch
    # norms normalise over 64 and 16 values, so the step amplifies an ulp
    # (on the CPU the port's f32 gradients lie 4.2e-4 from JAX's f32 and
    # JAX's f32 6e-5 from its float64; loss 2.2e-4)
    for e, what in ((f, "JAX's f32"), (f64, "JAX's float64")):
        check(e[0] <= 1e-3 and e[1] <= 1e-3 and e[2] <= 1e-4,
              f"B0 live step f32 on the card != {what}: loss {e[0]:.3e}, "
              f"gradients {e[1]:.3e}, statistics {e[2]:.3e}")
    out["golden"] = {"loss_rel": d_loss, "logits_abs": d_logits,
                     "grad_rel": d_grad, "grad_norm_rel": d_norm,
                     "adamw_loss_rel": d_adam,
                     "live_f64_vs_jax_f64": dict(zip(
                         ("loss_rel", "grad_rel", "stats_rel"), v)),
                     "live_f32_vs_jax_f32": dict(zip(
                         ("loss_rel", "grad_rel", "stats_rel"), f)),
                     "live_f32_vs_jax_f64": dict(zip(
                         ("loss_rel", "grad_rel", "stats_rel"), f64))}
    print(f"B0 training (a), golden steps against JAX ({smi_line}): recipe "
          f"(freeze_bn) loss {loss_card:.8f} (JAX {float(z['loss']):.8f}, "
          f"rel {d_loss:.3e} <= 1e-4), logits max |d| {d_logits:.3e}, "
          f"gradients max|d|/max|g| {d_grad:.3e} (<= 1e-3), norms rel "
          f"{d_norm:.3e}; 3 AdamW steps: losses rel {d_adam:.3e} (<= 1e-4); "
          f"live step (batch statistics, head dropout, running update), "
          f"loss / gradients / running statistics: in float64 on JAX's "
          f"inputs against JAX's float64 {v[0]:.3e} / {v[1]:.3e} / "
          f"{v[2]:.3e} (<= 1e-6); in f32 against JAX's f32 {f[0]:.3e} / "
          f"{f[1]:.3e} / {f[2]:.3e} and against JAX's float64 {f64[0]:.3e} "
          f"/ {f64[1]:.3e} / {f64[2]:.3e} (<= 1e-3 / 1e-3 / 1e-4)")

    # (c) the card against the CPU on the recipe's golden draws
    loss_cpu, _, g_cpu = recipe_step(cpu)
    c_loss = abs(loss_card / loss_cpu - 1)
    c_grad = _rel_grad_err(g_card, g_cpu)
    check(c_loss <= 1e-4 and c_grad <= 1e-3,
          f"B0 card vs CPU: loss rel {c_loss:.3e}, gradients {c_grad:.3e}")
    out["card_vs_cpu"] = {"loss_rel": c_loss, "grad_rel": c_grad}
    print(f"B0 training (c), card against CPU on the golden draws "
          f"({smi_line}): loss rel {c_loss:.3e} (<= 1e-4), gradients "
          f"{c_grad:.3e} (<= 1e-3)")

    # (b) both committed recipes at full width, f32 and bf16
    out["full_width"] = [time_b0_recipe(label, r, dtype, smi_line)
                         for label, r in B0_RUNS.items()
                         for dtype in ("float32", "bfloat16")]
    print("B0 training step_ms: CUDA events over 5 steps after 2 warm-up "
          "steps (draws, flips and rot90, the alpha mix, LSBr, "
          "preprocessing, forward and backward in eval mode (freeze_bn), "
          "AdamW and schedule; the host reads each loss, as the trainer "
          "does); img_per_s: the 4 images of a step (2 covers, 2 stegos) "
          "by host clock over the same 5 steps; peak_mem: "
          "torch.cuda.max_memory_allocated over them; busy_share: union "
          "of device kernel spans over host wall time of one profiled "
          "step; kernels_per_step: the kernels launched in that step")

    # (d) the loop closes: train_names resumed from the committed run,
    # load and score the result, then recalibrate it
    root = REPO / "build" / "smoke_b0_train"
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    pixels = z["pixels"].reshape(-1, 128, 128)
    names = []
    for i, img in enumerate(pixels):
        names.append(f"images/{i}.npy")
        np.save(root / names[-1], img)
    shutil.copytree(REPO / "weights" / "b0" / "LSBR" / run,
                    root / "runs" / "LSBR" / run)
    cfg_d = {**cfg, "crop": 64, "steps_per_epoch": 2, "num_epochs": 2,
             "val_steps": 1, "resume": run}
    exp = train_names(cfg_d, root, names[:6], names[6:], root / "runs",
                      device="cuda", reader=np.load)
    model, _ = load_pretrained_b0(exp.parent, exp.name, device="cuda")
    prob = infer_b0(model, pixels[:4], device="cuda")
    check(prob.shape == (4,) and bool(torch.isfinite(prob).all()),
          "the trained run's P(stego) is not finite")
    rows_csv = (exp / "log" / "scalars.csv").read_text().split()
    check(len(rows_csv) == 16, f"scalars.csv has {len(rows_csv)} rows")
    dst = recalibrate_names(exp, root, names, num_batches=2, batch_size=2,
                            device="cuda", reader=np.load)
    (p0, s0), (p1, s1) = load_params(exp), load_params(dst)
    f0, f1, t0, t1 = map(flatten_tree, (p0, p1, s0, s1))
    same = sorted(f0) == sorted(f1) and all(np.array_equal(f0[k], f1[k])
                                            for k in f0)
    moved = sorted(t0) == sorted(t1) and all(
        not np.array_equal(t0[k], t1[k]) for k in t0)
    check(same and moved, "bn_recalibrate changed more than batch_stats")
    check(sorted(p.name for p in (dst / "model").iterdir()) == ["best"],
          "the -bnrecal run keeps a latest checkpoint")
    sd = b0_state_dict_from_flax(p1, s1)
    check(all(torch.equal(v.cpu(), sd[k]) for k, v in
              load_pretrained_b0(dst.parent, dst.name,
                                 device="cuda")[0].state_dict().items()
              if not k.endswith("num_batches_tracked")),
          "the recalibrated run does not load as written")
    out["loop"] = {"run": exp.name, "prob": prob.tolist(),
                   "recalibrated": dst.name}
    print(f"B0 training (d), train_names (resumed from {run}) -> "
          f"load_pretrained_b0 -> infer_b0: {exp.name}; P(stego) "
          f"{prob.cpu().numpy()}; recalibrate_names -> {dst.name}: "
          f"parameters unchanged, all {len(t0)} running statistics moved")
    shutil.rmtree(root)

    # (e) filters-eval's step: against JAX on the golden covers, then
    # timed at 512x512, B=128
    zf = np.load(GOLDEN_FILTERS)
    covers = torch.from_numpy(np.load(GOLDEN)["pixels"][0]).to(dev)
    color = torch.from_numpy(np.load(GOLDEN_B0)["color/pixels"]).to(dev)
    worst = 0.0
    for f in zf["filters"]:
        kernel = taps_to_kernel2d(NAMED_FILTERS[str(f)])
        for b in zf["inbayer"]:
            b = str(b)
            got = [mae_wmae(covers[i:i + 8], kernel,
                            inbayer=None if b == "none" else b)
                   for i in range(0, len(covers), 8)]
            for j, key in enumerate(("mae", "wmae")):
                want = zf[f"{key}/{f}/{b}"]
                v = torch.cat([g[j] for g in got]).cpu().numpy()
                worst = max(worst, float(np.abs(v / want - 1).max()))
        for c in range(3):
            got = [mae_wmae(p, kernel, channel=c) for p in color]
            for j, key in enumerate(("mae", "wmae")):
                v = torch.stack([g[j] for g in got]).cpu().numpy()
                worst = max(worst, float(np.abs(
                    v / zf[f"color/{key}/{f}/{c}"] - 1).max()))
    check(worst <= 1e-5, f"filters-eval on the card != JAX: rel {worst:.3e}")
    big = torch.from_numpy(smooth_covers(128, 512, seed=61)).to(dev)
    kb = taps_to_kernel2d(NAMED_FILTERS["KB"])
    mae, wmae = mae_wmae(big, kb)
    small = mae_wmae(big[:4], kb)
    d_big = max(float(np.abs(a[:4].cpu().numpy() / b.cpu().numpy() - 1)
                      .max()) for a, b in zip((mae, wmae), small))
    check(bool(torch.isfinite(mae).all() & torch.isfinite(wmae).all()) and
          d_big <= 1e-6, f"filters-eval at B=128 != B=4 ({d_big:.3e})")
    ms = cuda_ms(lambda v: mae_wmae(v, kb), [big], reps=3, iters=5)
    out["filters"] = {"golden_rel": worst, "b128_vs_b4_rel": d_big,
                      "ms_b128": ms, "img_per_s": 128e3 / ms}
    print(f"filters-eval (e) on the card ({smi_line}): KB and AVG, every "
          f"inbayer on the 64 golden covers and channels 0-2 of the color4 "
          f"case against JAX: max rel {worst:.3e} (<= 1e-5); KB, channel "
          f"3, 512x512, B=128 ({128 * 510 * 510:,} cost values a decile "
          f"batch): {ms:.3f} ms a batch by CUDA events, "
          f"{128e3 / ms:.1f} img/s; B=128 rows against B=4: rel "
          f"{d_big:.3e}")
    del big, covers, color
    torch.cuda.empty_cache()
    check(fused_reflect_conv.launches == 0 and fused_ws.launches == 0,
          "a TPU-kernel port launched on the B0 training path")
    return out


GOLDEN_ANALYSES = REPO / "weights" / "golden" / "p128_analyses.npz"
# correlation against JAX's (tests/test_torch_analyses.py): rtol 1e-5
# (filters) or 1e-4 (U-Nets), and atol 1e-7, the statistic's own f32
# rounding: at alpha 0.1 some pairs' correlation is 5e-8 (the reference's
# x_hat.std() normaliser), where the CPU differs from JAX by 1.4e-8
CORR_ATOL = 1e-7
# a trained U-Net's prediction against JAX's, per pixel (0..255): 1e-6 of
# its 0..1 sigmoid output, times 255 (tests/test_torch_analyses.py)
UNET_PIXEL_ATOL = 2.55e-4
# the saliency subcommand's default points, at 512x512
SALIENCY_POINTS = [(307, 10), (261, 64), (155, 381), (9, 25)]


# images a slice when a launch is held to B1's plain version: the plain
# version in f32 of 16 images of the widest 512x512 layer needs about 13 GB
CHECK_IMAGES = 16


def checking_b1(calls: list, where: str):
    """A stand-in for ``fused_reflect_conv._launch`` that holds every
    launch against B1's plain version in f32 on the same activations
    (``CHECK_IMAGES`` images at a time, every output row), at phase 5's
    bounds, and records (dtype, max |err|) in ``calls``."""
    from wsunet_tpu_torch.ops import fused_reflect_conv

    launch = fused_reflect_conv._launch

    def checked_launch(x, w, b, relu):
        out = launch(x, w, b, relu)
        err, ok = 0.0, True
        for i in range(0, x.shape[0], CHECK_IMAGES):
            want = fused_reflect_conv.conv3x3_reflect_fused_plain(
                x[i:i + CHECK_IMAGES].float(), w.float(), b.float(), relu)
            e, o = b1_err(out[i:i + CHECK_IMAGES], want)
            err, ok = max(err, e), ok and o
            del want
        calls.append((x.dtype, err))
        check(ok, f"B1 on {where}, {str(x.dtype)[6:]} "
                  f"{tuple(x.shape)}->{w.shape[3]}: max |err| {err}")
        return out
    return checked_launch


def write_npy(root: pathlib.Path, folder: str, images) -> list:
    """``images`` as ``<folder>/<i>.npy`` under ``root``; their names."""
    (root / folder).mkdir(parents=True, exist_ok=True)
    names = [f"{folder}/{i:02d}.npy" for i in range(len(images))]
    for name, img in zip(names, images):
        np.save(root / name, img)
    return names


def analyses_path(smi_line: str) -> dict:
    """Phase 13: the analyses and the serving CLI's loops; (a) against the
    JAX package's numbers, (b) at full width, (c) the hooks."""
    from wsunet_tpu_torch.analyses.contour import difference_image
    from wsunet_tpu_torch.analyses.correlation import (correlation_rows,
                                                       unet_runs)
    from wsunet_tpu_torch.analyses.error_boxes import (box_stats,
                                                       residual_populations)
    from wsunet_tpu_torch.analyses.saliency import (saliency_patch,
                                                    saliency_patches,
                                                    sobel_locations)
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.serve import (load_server, measure_latency,
                                        serve_lines, stream_paths)
    from wsunet_tpu_torch.utils import profiling
    from wsunet_tpu_torch.ws import load_pretrained_unet

    gold = np.load(GOLDEN_ANALYSES)
    lsbr = np.load(GOLDEN)
    unet_dir = REPO / "weights" / "unet"
    root = REPO / "build" / "smoke_analyses"
    shutil.rmtree(root, ignore_errors=True)
    s = list(lsbr["sets"]).index(str(float(gold["alpha"])))
    names_c = write_npy(root, "images", lsbr["pixels"][0])
    names_s = write_npy(root, "stego", lsbr["pixels"][s])
    names = [str(n) for n in gold["names"]]
    unets = unet_runs(unet_dir, ["dropout", "LSBR", "HILLR"])
    check([run.name for _, run in unets] ==
          [str(r) for r in gold["unet_runs"]], f"U-Net runs {unets}")
    labels = [str(m) for m in gold["correlation_models"]]
    n_pairs = len(names_c)

    b1_calls = []
    launch = fused_reflect_conv._launch
    fused_reflect_conv._launch = checking_b1(b1_calls, "the analyses path")
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    worst = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), float(err))

    try:
        # (a) against JAX on the card, both conv routes
        for fc in (False, True):
            before = fused_reflect_conv.launches
            rows = correlation_rows(root, names_c, names_s, unets=unets,
                                    fast_conv=fc, reader=np.load)
            check([r["model_name"] for r in rows[::n_pairs]] == labels,
                  f"correlation labels {rows[::n_pairs]}")
            for k, label in enumerate(labels):
                part = rows[n_pairs * k:n_pairs * (k + 1)]
                cor = np.array([r["correlation"] for r in part])
                pv = np.array([r["p-value"] for r in part])
                want_c = gold[f"correlation/{label}"]
                want_p = gold[f"p-value/{label}"]
                rtol = 1e-4 if label.startswith("UNet") else 1e-5
                d_cor = np.abs(cor - want_c)
                nz = want_p > 0
                lrel = float(np.max(np.abs(np.log(pv[nz]) -
                                           np.log(want_p[nz])) /
                                    np.abs(np.log(want_p[nz])))) \
                    if nz.any() else 0.0
                kind = "unet" if label.startswith("UNet") else "filter"
                note(f"correlation |d|, {kind}", d_cor.max())
                note("log p rel", lrel)
                check(np.all(d_cor <= rtol * np.abs(want_c) + CORR_ATOL) and
                      lrel <= 1e-3 and ((pv == 0) == (want_p == 0)).all(),
                      f"correlation {label} fast_conv={fc}: max |d| "
                      f"{d_cor.max()}, log p rel {lrel}")
            check(fused_reflect_conv.launches - before ==
                  (len(unets) * (n_pairs // 8) * 10 if fc else 0),
                  f"correlation fast_conv={fc}: B1 launches")
            pops = residual_populations(
                root, names_c, unets=[("UNet_l1", unets[0][1]),
                                      ("UNet_l1ws", unets[1][1])],
                fast_conv=fc, reader=np.load)
            table = box_stats(pops, "KB")
            check([r["Type"] for r in table] == list(gold["boxes/Type"]) and
                  [r["edge_interval"] for r in table] ==
                  list(gold["boxes/edge_interval"]),
                  "error-box buckets != JAX's")
            for r, want in zip(table, gold["boxes/stats"]):
                got = np.array([r[c] for c in gold["boxes/columns"]])
                unet = r["Type"].startswith("UNet")
                bound = (1e-4 * np.abs(want) + UNET_PIXEL_ATOL) if unet \
                    else 1e-5 * np.abs(want)
                note("box stats " + ("unet" if unet else "filter"),
                     np.max(np.abs(got - want)))
                check(np.all(np.abs(got - want) <= bound),
                      f"error box {r['Type']} {r['edge_interval']} "
                      f"fast_conv={fc}: {got} against JAX {want}")
            for i, name in enumerate(gold["diff/names"]):
                f = root / names_c[names.index(str(name))]
                kb = difference_image(f, "KB", reader=np.load)
                unet = difference_image(f, "UNet", unet_dir, "LSBR",
                                        fast_conv=fc, reader=np.load)
                d_kb = float(np.abs(kb - gold["diff/KB"][i]).max())
                d_unet = float(np.abs(unet - gold["diff/UNet"][i]).max())
                note("diff KB", d_kb)
                note("diff UNet", d_unet)
                check(d_kb <= 1e-4 and d_unet <= UNET_PIXEL_ATOL,
                      f"difference images fast_conv={fc}: "
                                      f"KB {d_kb}, UNet {d_unet}")
            f = root / names_c[names.index(str(gold["saliency/name"]))]
            points = [tuple(map(int, p)) for p in gold["saliency/points"]]
            patches = np.stack(saliency_patches(f, points, unet_dir, "LSBR",
                                                fast_conv=fc,
                                                reader=np.load))
            d_sal = float(np.abs(patches - gold["saliency/patches"]).max())
            note("saliency", d_sal)
            check(d_sal <= 1e-4, f"saliency fast_conv={fc}: {d_sal}")
        locs = sobel_locations(f, reader=np.load)
        got = [tuple(map(int, v)) for v in locs.values()]
        want = [tuple(map(int, v)) for v in gold["sobel/points"]]
        check(list(locs) == list(gold["sobel/keys"]) and got == want,
              f"sobel_locations {got} against JAX {want}")
        launches_a = fused_reflect_conv.launches
        print(f"analyses on the card against JAX (64 p128 covers and their "
              f"LSBr stego at alpha {float(gold['alpha'])}, both fast_conv "
              f"routes): correlation of 4 filters and 3 trained U-Nets, the "
              f"error-box statistics, the KB and U-Net difference images, "
              f"4 saliency patches, sobel_locations {got}; worst: " +
              json.dumps(worst) + f"; B1 launches {launches_a}")

        # (b) at full width: unet_2 at 512x512 on the trained LSBR run
        cover = smooth_covers(1, 512, seed=21)[0]
        (big,) = write_npy(root, "full", [cover])
        sal = {fc: np.stack(saliency_patches(
            root / big, SALIENCY_POINTS, unet_dir, "LSBR", fast_conv=fc,
            reader=np.load)) for fc in (False, True)}
        d_sal = float(np.abs(sal[True] - sal[False]).max())
        sal_max = float(np.abs(sal[False]).max())
        check(np.all(np.isfinite(sal[True])) and sal_max > 0 and
              d_sal <= 1e-3 * sal_max,
              f"512x512 saliency through B1 != cuDNN route: {d_sal}")
        server, run = load_server(unet_dir, "LSBR", 512, torch.bfloat16,
                                  fast_conv=True)
        covers = smooth_covers(40, 512, seed=22)
        paths = [str(root / n) for n in write_npy(root, "serve", covers)]
        bad = str(root / "serve" / "bad.npy")
        np.save(bad, covers[0][:256])
        before = dict(fused_reflect_conv.launches_by_variant)
        streamed = list(stream_paths(server, paths[:32], reader=np.load))
        lines = paths[32:35] + [bad] + paths[35:39] + [""]
        serial = list(serve_lines(server, lines, reader=np.load))
        serve_counts = {k: v - before[k] for k, v in
                        fused_reflect_conv.launches_by_variant.items()}
        n_req = 32 + 7
        check(serve_counts == {"wgmma": 9 * n_req, "direct": n_req,
                               "fma": 0},
              f"serve loop: B1 launches {serve_counts} for {n_req} requests")
        check(len(serial) == 8 and "error" in serial[3] and
              serial[3]["error"].startswith("ValueError: expected 512x512"),
              f"serve loop: wrong-shape line {serial[3:4]}")
        outs = streamed + serial[:3] + serial[4:]
        got = np.array([[o["beta_hat"], o["l1"]] for o in outs])
        want = np.array([server.predict(im) for im in covers[:39]])
        check(np.allclose(got, want, rtol=1e-6, atol=1e-7) and
              np.all(np.isfinite(got)),
              "serve loop != UNetWSServer.predict")
        corr_cov = smooth_covers(64, 512, seed=23)
        names_c5 = write_npy(root, "c512", corr_cov)
        names_s5 = write_npy(root, "s512", lsb_replace(corr_cov, 1.0,
                                                       seed=24))
        corr = {fc: correlation_rows(root, names_c5, names_s5, unets=unets,
                                     fast_conv=fc, reader=np.load)
                for fc in (False, True)}
        c = {fc: np.array([r["correlation"] for r in corr[fc]])
             for fc in corr}
        d_corr = float(np.max(np.abs(c[True] - c[False])))
        check(np.allclose(c[True], c[False], rtol=1e-4, atol=1e-6),
              f"512x512 correlation: B1 route != cuDNN route, max |d| "
              f"{d_corr}")
        b1_launches = fused_reflect_conv.launches
    finally:
        fused_reflect_conv._launch = launch
    by_dtype = {dt: [e for d, e in b1_calls if d == dt]
                for dt in (torch.float32, torch.bfloat16)}
    check(len(b1_calls) == b1_launches, "a B1 launch escaped the check")
    check(fused_ws.launches == 0, f"B2 ran {fused_ws.launches} times on "
                                  "the analyses path")
    print(f"B1 = plain on every launch of the analyses path: "
          f"{len(by_dtype[torch.float32])} f32 launches, max |err| "
          f"{max(by_dtype[torch.float32]):.3e}; "
          f"{len(by_dtype[torch.bfloat16])} bf16 launches, max |err| "
          f"{max(by_dtype[torch.bfloat16]):.3e}; B2 launches 0")

    # the times, without the per-launch check
    model = {fc: load_pretrained_unet(unet_dir / "LSBR", run,
                                      fast_conv=fc)[0]
             for fc in (False, True)}
    sal_ms = {}
    for fc, m in model.items():
        saliency_patch(m, cover, *SALIENCY_POINTS[0])
        t0 = time.perf_counter()
        for i, j in SALIENCY_POINTS:
            saliency_patch(m, cover, i, j)
        sal_ms[fc] = 1e3 * (time.perf_counter() - t0) / len(SALIENCY_POINTS)
    del model
    serving = {}
    for fc in (True, False):
        srv = server if fc else load_server(unet_dir, "LSBR", 512,
                                            torch.bfloat16)[0]
        list(stream_paths(srv, paths[:8], reader=np.load))
        t0 = time.perf_counter()
        list(stream_paths(srv, paths[:32], reader=np.load))
        serving[fc] = {"paths_streamed_img_s":
                       32 / (time.perf_counter() - t0),
                       **measure_latency(srv, reps=30)}
        del srv
    corr_ips = {}
    for fc in (False, True):
        t0 = time.perf_counter()
        correlation_rows(root, names_c5, names_s5, unets=unets,
                         fast_conv=fc, reader=np.load)
        corr_ips[fc] = len(names_c5) / (time.perf_counter() - t0)
    print(f"full width ({smi_line}), trained LSBR unet_2 {run} at "
          f"512x512: saliency f32, 4 points {SALIENCY_POINTS} (B1 against "
          f"cuDNN max |d| {d_sal:.3e}, max |patch| {sal_max:.4e}): "
          f"{sal_ms[True]:.2f} ms a point on B1, {sal_ms[False]:.2f} on "
          f"cuDNN (host clock, the gradient on the host); serve bf16, "
          f"stream_paths over 32 .npy paths (host clock, decode included) "
          f"and measure_latency, --fast-conv: " + json.dumps(serving[True]) +
          "; cuDNN: " + json.dumps(serving[False]) +
          f"; correlation core over 64 pairs (4 filters + 3 U-Nets, f32, "
          f"B=8; B1 against cuDNN max |d| {d_corr:.3e}): "
          f"{corr_ips[True]:.2f} pairs/s on B1, {corr_ips[False]:.2f} on "
          "cuDNN (host clock, .npy decode and the host's correlation "
          "included)")

    # (c) the hooks on the card
    trace_dir = root / "trace"
    os.environ["WSUNET_PROFILE"] = str(trace_dir)
    try:
        m = load_pretrained_unet(unet_dir / "LSBR", run, fast_conv=True)[0]
        with profiling.profile():
            saliency_patch(m, cover, *SALIENCY_POINTS[0])
    finally:
        del os.environ["WSUNET_PROFILE"]
    (trace,) = trace_dir.glob("*.pt.trace.json")
    kernels = {e["name"] for e in json.loads(trace.read_text())[
        "traceEvents"] if e.get("cat") == "kernel"}
    b1_named = sorted({v for k in kernels for v in ("fma_kernel",
                                                    "direct_kernel")
                       if v in k})
    check(b1_named == ["direct_kernel", "fma_kernel"],
          f"the trace names B1's kernels {b1_named}: {sorted(kernels)}")
    with profiling.nan_check():
        raised = []
        try:
            torch.zeros(4, device="cuda") / 0
        except FloatingPointError as e:
            raised.append(str(e))
        x, w, b = conv_inputs((1, 8, 8, 16), 16, torch.float32, seed=3)
        try:
            fused_reflect_conv.conv3x3_reflect_fused(
                torch.zeros_like(x), torch.full_like(w, float("inf")), b)
        except FloatingPointError as e:
            raised.append(str(e))
    check(len(raised) == 2 and "B1" in raised[1],
          f"nan_check on the card raised {raised}")
    print(f"hooks: WSUNET_PROFILE around one saliency call wrote "
          f"{trace.name} naming B1's kernels {b1_named}; nan_check raised "
          f"FloatingPointError in a torch op ({raised[0]}) and at B1's "
          f"output ({raised[1]})")
    shutil.rmtree(root)
    return {"b1_launches": b1_launches}


# ---- phase 14: the parallel path (wsunet_tpu_torch.parallel)
PARALLEL_JOB = REPO / "build" / "smoke_parallel"
# the two gloo ranks' own limit: a rank that hangs fails the phase
RANK_TIMEOUT = 300
# B0's rows of a rank-sharded sweep against the one-process rows: B0's
# kernels need not be invariant to an image's place in its batch (on the
# CPU they are not: tests/test_torch_parallel.py)
B0_SHARD_RTOL = 1e-6
# infer_unet_spatial against infer_unet, 0..255 (tests/test_multichip.py)
SPATIAL_UNET_ATOL = 1e-3
# phase 14 (c)'s sweeps: 128 512x512 covers as .npy files, at the CLI's
# default batch
SWEEP_DIR, SWEEP_N, SWEEP_BATCH = "sweep512", 128, 8
# an f32 B0 step on a group against the step without one and against
# JAX's f32 step: loss rel, logits, gradients (phase 12's f32 bound)
B0_F32 = 1e-3


def checking_b2(calls: list, where: str):
    """A stand-in for ``fused_ws._launch`` that holds every launch against
    B2's plain version on the same input (phase 2's bounds) and records
    max |err| in ``calls``."""
    from wsunet_tpu_torch.ops import fused_ws

    launch = fused_ws._launch

    def checked_launch(x_u8, kernel_name, weighted):
        out = launch(x_u8, kernel_name, weighted)
        want = fused_ws.ws_attack_fused_plain(x_u8, kernel_name, weighted)
        err = float((out - want).abs().max()) if out.numel() else 0.0
        calls.append(err)
        check(torch.allclose(out, want, rtol=RTOL, atol=ATOL),
              f"B2 on {where}, {kernel_name} weighted={weighted} "
              f"{tuple(x_u8.shape)}: max |err| {err}")
        return out
    return checked_launch


def golden_draws(z, prefix: str, dev) -> dict:
    return {k[len(prefix):]: (torch.from_numpy(z[k]).long()
                              if z[k].dtype.kind == "i"
                              else torch.from_numpy(z[k])).to(dev)
            for k in z.files if k.startswith(prefix)}


def _block(mesh, a: np.ndarray, dev) -> torch.Tensor:
    """This rank's block of a batch on ``dev`` (the whole batch without a
    mesh): what a data-parallel step takes."""
    t = torch.from_numpy(a)
    return (t if mesh is None else t[mesh.block(len(t))]).to(dev)


def unet_golden_step(mesh, dev) -> dict:
    """One AdamW step of the committed LSBR recipe on JAX's golden draws
    (B=4, crop 64), data parallel over ``mesh`` (None: no group): the
    loss and the gradients, in the Flax layout."""
    from wsunet_tpu_torch.models import (flax_params_from_unet_state_dict,
                                         get_model, unet_state_dict_from_flax)
    from wsunet_tpu_torch.train import get_loss, load_params
    from wsunet_tpu_torch.train.checkpoint import flatten_tree
    from wsunet_tpu_torch.train.train_unet import _make_step, make_optimizer

    z = np.load(GOLDEN_TRAIN)
    cfg = json.loads(str(z["config"]))
    model = get_model(cfg["network"])
    model.load_state_dict(unet_state_dict_from_flax(load_params(
        REPO / "weights" / "unet" / "LSBR" / str(z["run"]))[0]))
    model.to(dev)
    fn = get_loss(cfg["loss"], per_image=True,
                  loss_lambda=cfg["loss_lambda"])
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"],
                              model.parameters())
    step = _make_step(model, fn, opt, sch, cfg["stego_method"],
                      cfg["alpha"], crop=cfg["crop"], augment=cfg["augment"],
                      cover_fraction=cfg["cover_fraction"], mesh=mesh)[0]
    loss = step(_block(mesh, z["pixels"][0], dev),
                _block(mesh, z["mask"][0], dev),
                draws=golden_draws(z, "draws/0/", dev))
    grads = flax_params_from_unet_state_dict(
        {k: p.grad for k, p in model.named_parameters()})
    return {"loss": float(loss), "grad": flatten_tree(grads)}


# phase 14's B0 golden steps: (live, dtype); the live float64 step runs on
# the table of JAX's jitted preprocessing, as JAX's float64 step
B0_STEPS = {"b0_live64": (True, torch.float64),
            "b0_live32": (True, torch.float32),
            "b0_recipe32": (False, torch.float32)}


def b0_golden_step(mesh, dev, live: bool, dtype) -> dict:
    """One B0 step on JAX's golden draws (B=2 pairs), data parallel over
    ``mesh``: the committed recipe (``freeze_bn``, its first step) or,
    with ``live``, the step with batch statistics, head dropout and the
    running update, the model in ``dtype``: loss, logits, gradients and
    running statistics."""
    from wsunet_tpu_torch.train.train_b0 import _make_steps
    from wsunet_tpu_torch.train.train_unet import make_optimizer

    z = np.load(GOLDEN_B0_TRAIN)
    cfg = {**_b0_config(str(z["run"])), "freeze_bn": not live}
    model = _b0_model(cfg, str(z["run"]), dev, dtype=dtype)
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"],
                              model.parameters())
    step = _make_steps(model, opt, sch, cfg, mesh=mesh)[0]
    if dtype == torch.float64:
        lut = torch.from_numpy(z["live/preprocess_lut"]).to(dev)
        step.sampler.preprocess = lambda x_u8: lut[x_u8.long()][:, None]
    prefix, i = ("live/draws/", -1) if live else ("draws/0/", 0)
    loss, logits, _ = step(_block(mesh, z["pixels"][i], dev),
                           _block(mesh, z["mask"][i], dev),
                           draws=golden_draws(z, prefix, dev))
    grads, stats = _b0_grads(model)
    return {"loss": float(loss), "logits": logits.double().cpu().numpy(),
            "grad": grads, "stats": stats}


def parallel_work(job: pathlib.Path, mesh) -> dict:
    """What phase 14 drives under a process group (the smoke's own one-rank
    nccl group, or each of two gloo ranks): the three sweeps over the
    ``.npy`` covers of ``job`` (B2 on KB and KB-w, B1 in the fast-conv
    U-Net, B0), ``ws_attack_spatial`` at 8x512x512 and
    ``infer_unet_spatial`` at 4x512x512, and the golden steps of each
    trainer.
    Every B1 and B2 launch is held against its plain version; their
    launch counts cover this drive alone."""
    from wsunet_tpu_torch.data import pipeline
    from wsunet_tpu_torch.detect.b0_eval import get_b0_detector, score_sweep
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.parallel.spatial import (infer_unet_spatial,
                                                   ws_attack_spatial)
    from wsunet_tpu_torch.ws import (attack_batches, load_pretrained_unet,
                                     predict_sweep)

    from wsunet_tpu_torch.ops import NAMED_FILTERS_2D

    kb = NAMED_FILTERS_2D["KB"]
    dev = torch.device("cuda")
    names = sorted(f"images/{p.name}" for p in (job / "images").glob("*"))
    run = str(np.load(GOLDEN)["run"])
    lsbr = REPO / "weights" / "unet" / "LSBR"
    fast = load_pretrained_unet(lsbr, run, fast_conv=True)[0]
    f32 = load_pretrained_unet(lsbr, run)[0]
    detect = get_b0_detector(REPO / "weights" / "b0" / "LSBR",
                             B0_RUNS["strided"])
    x8 = torch.from_numpy(smooth_covers(8, 512, seed=61)).to(dev)
    x4 = torch.from_numpy(smooth_covers(4, 512, seed=62)).to(dev).float()
    out = {"rank": mesh.rank, "world": mesh.world}
    b1_calls, b2_calls = [], []
    launch1, launch2 = fused_reflect_conv._launch, fused_ws._launch
    fused_reflect_conv._launch = checking_b1(b1_calls, "the parallel path")
    fused_ws._launch = checking_b2(b2_calls, "the parallel path")
    pipeline.clear_decode_cache()
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    try:
        for det in ("KB", "KB-w"):
            w = 1 if det == "KB-w" else 0
            out[f"sweep/{det}"] = pipeline.sweep_batches(
                job, names, lambda px, w=w: (torch.from_numpy(attack_batches(
                    [px], kernel_name="KB", weighted=w)),), 8,
                reader=np.load).reshape(-1)
        out["sweep/beta"], out["sweep/l1"] = predict_sweep(
            job, names, fast, 8, reader=np.load)
        out["sweep/b0"] = score_sweep(job, names, detect, 8, reader=np.load)
        for w in WEIGHTS:
            out[f"spatial/{w}"] = ws_attack_spatial(
                x8, kb, weighted=w).cpu().numpy()
        out["unet_spatial"] = infer_unet_spatial(f32, x4).cpu().numpy()
    finally:
        fused_reflect_conv._launch, fused_ws._launch = launch1, launch2
    out["b1_launches"] = dict(fused_reflect_conv.launches_by_variant)
    out["b2_launches"] = fused_ws.launches
    check(len(b1_calls) == sum(out["b1_launches"].values()) and
          len(b2_calls) == out["b2_launches"],
          "a launch on the parallel path escaped the check")
    out["b1_max_err"] = max(e for _, e in b1_calls)
    out["b2_max_err"] = max(b2_calls)
    out["unet_step"] = unet_golden_step(mesh, dev)
    for kind, (live, dtype) in B0_STEPS.items():
        out[kind] = b0_golden_step(mesh, dev, live, dtype)
    pipeline.clear_decode_cache()
    return out


def host_ms(fn, mesh, reps: int) -> float:
    """Host-clock ms of one call of ``fn`` (a warm-up call first), every
    rank in step: a barrier and a synchronise around the timed calls."""
    fn()
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    mesh.barrier()
    return 1e3 * (time.perf_counter() - t0) / reps


def parallel_times(job: pathlib.Path, mesh, baselines: bool) -> dict:
    """Phase 14 (c) on this rank, host clock: ``ws_attack_spatial`` at
    128x512x512, ``infer_unet_spatial`` at 4x512x512 in f32 and bf16
    (with ``baselines``, beside B2's and the plain attack's time on the
    same batch and ``infer_unet``'s), and the three sweeps' img/s over the
    128 512x512 ``.npy`` covers of ``job/SWEEP_DIR`` at batch
    ``SWEEP_BATCH`` (their decodes cached by a first pass; at one rank
    the batches stay on the card after it, under ranks the device cache
    is off and every pass uploads)."""
    from wsunet_tpu_torch.data import pipeline
    from wsunet_tpu_torch.detect.b0_eval import get_b0_detector, score_sweep
    from wsunet_tpu_torch.ops import fused_ws, ws_attack
    from wsunet_tpu_torch.parallel.spatial import (infer_unet_spatial,
                                                   ws_attack_spatial)
    from wsunet_tpu_torch.ws import (attack_batches, infer_unet,
                                     load_pretrained_unet, predict_sweep)

    from wsunet_tpu_torch.ops import NAMED_FILTERS_2D

    kb = NAMED_FILTERS_2D["KB"]
    dev = torch.device("cuda")
    t = {}
    x128 = torch.from_numpy(smooth_covers(128, 512, seed=63)).to(dev)
    t["ws_attack_spatial_ms"] = host_ms(
        lambda: ws_attack_spatial(x128, kb), mesh, 10)
    if baselines:
        t["b2_ms"] = host_ms(
            lambda: fused_ws.ws_attack_fused(x128, "KB", 0), mesh, 10)
        t["plain_ms"] = host_ms(
            lambda: ws_attack(x128, pixel_kernel=kb), mesh, 5)
    del x128
    x4 = torch.from_numpy(smooth_covers(4, 512, seed=64)).to(dev).float()
    run = str(np.load(GOLDEN)["run"])
    lsbr = REPO / "weights" / "unet" / "LSBR"
    for dtype in (torch.float32, torch.bfloat16):
        m = load_pretrained_unet(lsbr, run, compute_dtype=dtype)[0]
        tag = str(dtype)[6:]
        t[f"unet_spatial_{tag}_img_s"] = 4e3 / host_ms(
            lambda: infer_unet_spatial(m, x4), mesh, 5)
        if baselines:
            t[f"unet_{tag}_img_s"] = 4e3 / host_ms(
                lambda: infer_unet(m, x4), mesh, 5)
    names = sorted(f"{SWEEP_DIR}/{p.name}"
                   for p in (job / SWEEP_DIR).glob("*"))
    fast = load_pretrained_unet(lsbr, run, fast_conv=True)[0]
    detect = get_b0_detector(REPO / "weights" / "b0" / "LSBR",
                             B0_RUNS["strided"])
    B = SWEEP_BATCH
    sweeps = {
        "KB": lambda: pipeline.sweep_batches(
            job, names, lambda px: (torch.from_numpy(attack_batches(
                [px], kernel_name="KB")),), B, reader=np.load),
        "unet_fast_conv": lambda: predict_sweep(job, names, fast, B,
                                                reader=np.load),
        "b0": lambda: score_sweep(job, names, detect, B, reader=np.load)}
    for label, sweep in sweeps.items():
        t[f"sweep_{label}_img_s"] = len(names) * 1e3 / host_ms(sweep, mesh,
                                                               3)
    pipeline.clear_decode_cache()
    return t


def parallel_rank(rank: int, world: int, job: pathlib.Path) -> int:
    """One of phase 14's two gloo ranks on the card (started by
    ``parallel_path`` as ``chip_smoke.py --parallel-rank R W JOB``): once
    ``JOB/go`` exists, the drive of ``parallel_work`` and the times,
    pickled to ``JOB/rank<R>.pkl``."""
    import pickle

    import torch.distributed as dist

    from wsunet_tpu_torch import detect, train, ws  # noqa: F401
    from wsunet_tpu_torch._device import disable_tf32
    from wsunet_tpu_torch.ops import _cuda_build
    from wsunet_tpu_torch.parallel import get_mesh
    from wsunet_tpu_torch.parallel.distributed import distributed_init

    # start-up (imports, the card, the kernels built in phase 2) while
    # the parent runs (a); the drive waits for its go
    disable_tf32()
    torch.zeros(1, device="cuda")
    _cuda_build.load_all(_cuda_build.SOURCES)
    deadline = time.monotonic() + RANK_TIMEOUT
    while not (job / "go").exists():
        check(time.monotonic() < deadline, "phase 14 never gave the go")
        time.sleep(0.05)
    check(distributed_init(init_method=f"file://{job / 'rdzv2'}",
                           world_size=world, rank=rank, backend="gloo"),
          "the two-rank group did not start")
    try:
        mesh = get_mesh()
        out = parallel_work(job, mesh)
        out["times"] = parallel_times(job, mesh, baselines=False)
        out["steps"] = step_times(mesh, baselines=False)
    finally:
        dist.destroy_process_group()
    with open(job / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


def _rel_max(got: dict, want: dict) -> float:
    """max over tensors of max|d| / max|want|."""
    return max(float(np.abs(got[k] - want[k]).max() /
                     max(np.abs(want[k]).max(), 1e-30)) for k in want)


def step_times(mesh, baselines: bool) -> dict:
    """Phase 14 (c): the U-Net LSBR recipe (512x512, B=4, f32) and the
    strided B0 recipe (512x512, B=2 pairs, f32) step ms on ``mesh``, each
    rank on its block of the batch, host clock (``host_ms``: 5 steps
    after 2 warm-up steps); with ``baselines`` beside the step without a
    group, in turns (none, mesh, mesh, none)."""
    from wsunet_tpu_torch.models import get_model, init_unet
    from wsunet_tpu_torch.train import get_loss
    from wsunet_tpu_torch.train.train_b0 import _make_steps
    from wsunet_tpu_torch.train.train_unet import _make_step, make_optimizer

    dev = torch.device("cuda")
    r = _LSBR_RECIPE

    def unet_step(m):
        model = init_unet(get_model("unet_2"), 0).to(dev)
        opt, sch = make_optimizer(r, 100, model.parameters())
        return _make_step(model, get_loss(r["loss"], per_image=True,
                                          loss_lambda=r["loss_lambda"]),
                          opt, sch, r["stego_method"], r["alpha"],
                          crop=r["crop"], augment=r["augment"], mesh=m)[0]

    def b0_step(m):
        cfg = _b0_config(B0_RUNS["strided"], compute_dtype="float32")
        model = _b0_model(cfg, B0_RUNS["strided"], dev)
        opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"],
                                  model.parameters())
        return _make_steps(model, opt, sch, cfg, mesh=m)[0]

    rows = {}
    turns = ("none", "mesh", "mesh", "none") if baselines else ("mesh",)
    for label, make, B in (("unet LSBR f32, B=4", unet_step, 4),
                           ("B0 strided f32, B=2 pairs", b0_step, 2)):
        covers = smooth_covers(B, 512, seed=71)
        ms = {}
        for which in turns:
            m = mesh if which == "mesh" else None
            step = make(m)
            x = _block(m, covers, dev)
            mask = torch.ones(len(x), dtype=torch.bool, device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            step(x, mask, gen)
            ms.setdefault(which, []).append(host_ms(
                lambda: step(x, mask, gen), mesh, 5))
            del step
            torch.cuda.empty_cache()
        rows[label] = {k: float(np.mean(v)) for k, v in ms.items()}
    return rows


def parallel_path(smi_line: str) -> dict:
    """Phase 14: the parallel path.  (a) a one-rank nccl group in this
    process: the three sweeps, the spatial paths and one step of each
    trainer, held against the golden numbers, B2, B1, the plain attack,
    ``infer_unet`` and the steps without a group; (b) two gloo ranks on
    the card (two processes of this script): the same, each held to (a);
    (c) times, as measurements."""
    gold, gold_b0 = np.load(GOLDEN), np.load(GOLDEN_B0)
    job = PARALLEL_JOB
    shutil.rmtree(job, ignore_errors=True)
    names = write_npy(job, "images", gold["pixels"][0])
    write_npy(job, SWEEP_DIR, smooth_covers(SWEEP_N, 512, seed=65))
    bad = 3
    (job / names[bad]).write_bytes(b"not an array")
    keep = np.arange(len(names)) != bad
    b0_label = str(gold_b0["labels"][list(gold_b0["runs"]).index(
        B0_RUNS["strided"])])
    # the two gloo ranks of (b) start up now and wait for (a) to end
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--parallel-rank",
         str(r), "2", str(job)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        return _parallel_path(smi_line, job, names, bad, keep, b0_label,
                              procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _parallel_path(smi_line, job, names, bad, keep, b0_label,
                   procs) -> dict:
    """The body of ``parallel_path``, with the two ranks started."""
    import pickle

    import torch.distributed as dist

    from wsunet_tpu_torch.ops import NAMED_FILTERS_2D, fused_ws, ws_attack
    from wsunet_tpu_torch.parallel import get_mesh
    from wsunet_tpu_torch.parallel.distributed import distributed_init
    from wsunet_tpu_torch.ws import infer_unet, load_pretrained_unet

    kb = NAMED_FILTERS_2D["KB"]
    dev = torch.device("cuda")
    gold, gold_b0 = np.load(GOLDEN), np.load(GOLDEN_B0)
    t0 = time.perf_counter()

    # (a) one rank under nccl, in this process
    check(distributed_init(init_method=f"file://{job / 'rdzv1'}",
                           world_size=1, rank=0, backend="nccl") is False
          and dist.get_backend() == "nccl", "the one-rank nccl group")
    try:
        mesh = get_mesh()
        a = parallel_work(job, mesh)
        times = {"world1": parallel_times(job, mesh, baselines=True)}
        steps = {"world1": step_times(mesh, baselines=True)}
    finally:
        dist.destroy_process_group()
    n_batches = len(names) // 8
    check(a["b2_launches"] == 2 * n_batches,
          f"B2 launches on the one-rank sweeps: {a['b2_launches']}")
    check(a["b1_launches"] == {"wgmma": 0, "direct": n_batches,
                               "fma": 9 * n_batches},
          f"B1 launches on the one-rank U-Net sweep: {a['b1_launches']}")
    for det in ("KB", "KB-w"):
        got = a[f"sweep/{det}"]
        check(np.isnan(got[bad]) and np.allclose(
            got[keep], gold[f"beta/{det}"][0][keep], rtol=RTOL, atol=ATOL),
            f"parallel {det} sweep != JAX, or no NaN row")
    d_beta = float(np.abs(a["sweep/beta"][keep] -
                          gold["beta/UNet"][0][keep]).max())
    d_l1 = float((np.abs(a["sweep/l1"][keep] - gold["l1"][0][keep]) /
                  gold["l1"][0][keep]).max())
    d_p = float(np.abs(a["sweep/b0"][keep] -
                       gold_b0[f"prob/{b0_label}"][0][keep]).max())
    check(np.isnan(a["sweep/beta"][bad]) and np.isnan(a["sweep/b0"][bad])
          and d_beta <= 1e-5 and d_l1 <= 1e-4 and d_p <= B0_ATOL,
          f"parallel U-Net / B0 sweeps != JAX ({d_beta}, {d_l1}, {d_p})")
    print(f"parallel path (a), one-rank nccl group: sweeps over "
          f"{len(names)} .npy covers (one corrupt: NaN rows): KB, KB-w "
          f"within rtol {RTOL}, atol {ATOL} of JAX; U-Net on B1 max |d "
          f"beta| {d_beta:.3e}, rel d l1 {d_l1:.3e}; B0 {b0_label} max |d "
          f"P| {d_p:.3e}; B2 launches {a['b2_launches']} (max |err| "
          f"{a['b2_max_err']:.3e}), B1 launches "
          f"{json.dumps(a['b1_launches'])} (max |err| "
          f"{a['b1_max_err']:.3e}), each held to its plain version")
    x8 = torch.from_numpy(smooth_covers(8, 512, seed=61)).to(dev)
    for w in WEIGHTS:
        fused = fused_ws.ws_attack_fused(x8, "KB", w).cpu().numpy()
        plain = ws_attack(x8, pixel_kernel=kb,
                          weighted=w).cpu().numpy()
        got = a[f"spatial/{w}"]
        check(np.allclose(got, fused, rtol=RTOL, atol=ATOL) and
              np.allclose(got, plain, rtol=RTOL, atol=ATOL),
              f"ws_attack_spatial weighted={w} != B2 / plain: "
              f"{np.abs(got - fused).max()}, {np.abs(got - plain).max()}")
    f32 = load_pretrained_unet(REPO / "weights" / "unet" / "LSBR",
                               str(gold["run"]))[0]
    x4 = torch.from_numpy(smooth_covers(4, 512, seed=62)).to(dev).float()
    d_sp = float(np.abs(a["unet_spatial"] -
                        infer_unet(f32, x4).cpu().numpy()).max())
    check(d_sp <= SPATIAL_UNET_ATOL,
          f"infer_unet_spatial != infer_unet: {d_sp}")
    print(f"parallel path (a): ws_attack_spatial 8x512x512, KB x weighted "
          f"{WEIGHTS}, within rtol {RTOL}, atol {ATOL} of B2 and of the "
          f"plain attack; infer_unet_spatial (trained unet_2, f32, "
          f"4x512x512) against infer_unet max |d| {d_sp:.3e} (<= "
          f"{SPATIAL_UNET_ATOL}, 0..255)")
    one_u = unet_golden_step(None, dev)
    one_b = {k: b0_golden_step(None, dev, *v) for k, v in B0_STEPS.items()}
    zb = np.load(GOLDEN_B0_TRAIN)

    def b0_errs(got, want):
        """(loss rel, logits max |d|, gradients max |d| of the largest,
        running statistics rel) of a B0 step against ``want``: against
        the largest gradient of any tensor, since the biases of norms that
        another norm follows have gradients at the rounding floor
        (tests/test_torch_train_b0.py)."""
        gmax = max(float(np.abs(v).max()) for v in want["grad"].values())
        return (abs(got["loss"] / want["loss"] - 1),
                float(np.abs(got["logits"] - want["logits"]).max()),
                max(float(np.abs(got["grad"][k] - v).max())
                    for k, v in want["grad"].items()) / gmax,
                _rel_max(got["stats"], want["stats"]))

    def jax_f32_errs(got, live):
        """(loss rel, logits max |d|, JAX's full gradients max|d|/max|g|)
        of an f32 B0 step against JAX's f32 golden step."""
        tag = "live/" if live else ""
        want = {k[len(f"{tag}grad/"):]: zb[k] for k in zb.files
                if k.startswith(f"{tag}grad/")}
        return (abs(got["loss"] / float(zb[f"{tag}loss"]) - 1),
                float(np.abs(got["logits"] - zb[f"{tag}logits"]).max()),
                _rel_grad_err(got["grad"], want))

    def steps_equal(got, tag, unet_bounds):
        du = _rel_max(got["unet_step"]["grad"], one_u["grad"])
        lu = abs(got["unet_step"]["loss"] / one_u["loss"] - 1)
        e64 = b0_errs(got["b0_live64"], one_b["b0_live64"])
        f32 = {k: (b0_errs(got[k], one_b[k]),
                   jax_f32_errs(got[k], B0_STEPS[k][0]))
               for k in ("b0_live32", "b0_recipe32")}
        print(f"parallel path {tag}: train_unet golden step against the "
              f"step without a group: loss rel {lu:.3e} (<= "
              f"{unet_bounds[0]}), gradients {du:.3e} (<= {unet_bounds[1]}); "
              f"B0 live float64 step: loss rel {e64[0]:.3e}, logits "
              f"{e64[1]:.3e}, gradients {e64[2]:.3e} (of the largest), "
              f"running statistics {e64[3]:.3e} (each <= 1e-6); " +
              "; ".join(
                  f"{k} against the step without a group: loss rel "
                  f"{e[0]:.3e}, logits {e[1]:.3e}, gradients {e[2]:.3e}, "
                  f"running statistics {e[3]:.3e} (<= {B0_F32}, 1e-4) and "
                  f"against JAX's f32 step: loss rel {j[0]:.3e}, logits "
                  f"{j[1]:.3e}, gradients {j[2]:.3e} (<= {B0_F32})"
                  for k, (e, j) in f32.items()))
        check(lu <= unet_bounds[0] and du <= unet_bounds[1] and
              max(e64) <= 1e-6 and
              all(max(e[:3]) <= B0_F32 and e[3] <= 1e-4 and
                  max(j) <= B0_F32 for e, j in f32.values()),
              f"{tag}: a step != the step without a group, or an f32 B0 "
              f"step != JAX's")

    steps_equal(a, "(a)", (1e-6, 1e-5))

    t_a = time.perf_counter() - t0

    # (b) two gloo ranks on the one card
    (job / "go").touch()
    for r, p in enumerate(procs):
        try:
            log = p.communicate(timeout=RANK_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            log = p.communicate()[0]
        check(p.returncode == 0,
              f"gloo rank {r} failed ({p.returncode}):\n{log[-3000:]}")
    t_b = time.perf_counter() - t0 - t_a
    ranks = []
    for r in range(2):
        with open(job / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    b0_diff = 0.0
    for r, got in enumerate(ranks):
        check(got["b2_launches"] == n_batches and got["b1_launches"] == {
            "wgmma": 0, "direct": n_batches // 2,
            "fma": 9 * n_batches // 2},
            f"rank {r}: launches B2 {got['b2_launches']}, B1 "
            f"{got['b1_launches']}")
        for key in ("sweep/KB", "sweep/KB-w", "sweep/beta", "sweep/l1"):
            check(np.array_equal(got[key], a[key], equal_nan=True),
                  f"rank {r}: {key} != the one-rank rows")
        check(np.array_equal(np.isnan(got["sweep/b0"]),
                             np.isnan(a["sweep/b0"])) and np.allclose(
            got["sweep/b0"][keep], a["sweep/b0"][keep], rtol=B0_SHARD_RTOL,
            atol=0), f"rank {r}: B0 rows != the one-rank rows")
        b0_diff = max(b0_diff, float(np.abs(got["sweep/b0"][keep] -
                                            a["sweep/b0"][keep]).max()))
        for w in WEIGHTS:
            check(np.allclose(got[f"spatial/{w}"], a[f"spatial/{w}"],
                              rtol=RTOL, atol=ATOL),
                  f"rank {r}: ws_attack_spatial weighted={w} != one rank")
        d = float(np.abs(got["unet_spatial"] - a["unet_spatial"]).max())
        check(d <= SPATIAL_UNET_ATOL,
              f"rank {r}: infer_unet_spatial != one rank ({d})")
        # a rank's half batch (2 of 4) takes other cuDNN f32 algorithms
        # than the whole: phase 11's card bounds (loss rel 1e-4, gradients
        # 1e-3), not the CPU's 1e-6 / 1e-5
        steps_equal(got, f"(b) rank {r}", (1e-4, 1e-3))
    print(f"parallel path (b), two gloo ranks on the card: each rank's "
          f"KB, KB-w and U-Net sweep rows equal the one-rank rows bit for "
          f"bit, B0's within {b0_diff:.3e} (rtol {B0_SHARD_RTOL}); B2 "
          f"launches a rank {ranks[0]['b2_launches']}, B1 "
          f"{json.dumps(ranks[0]['b1_launches'])}, each held to its plain "
          f"version (max |err| B2 "
          f"{max(g['b2_max_err'] for g in ranks):.3e}, B1 "
          f"{max(g['b1_max_err'] for g in ranks):.3e}); spatial paths "
          f"within the bounds of (a); gloo took the ranks' CUDA tensors "
          f"as they lie")
    print(f"parallel path: (a) {t_a:.1f} s, (b) {t_b:.1f} s after its go "
          "(the ranks started up during (a))")
    for r, got in enumerate(ranks):
        times[f"world2_rank{r}"] = got["times"]
        steps[f"world2_rank{r}"] = got["steps"]
    print(f"parallel path (c), host clock ({smi_line}): " +
          json.dumps(times))
    print(f"parallel path (c), trainer step ms, host clock, 5 steps after "
          f"2 warm-up steps ({smi_line}); world1: without a group (none) "
          f"and on the one-rank nccl group (mesh), mean of 2 runs each; "
          f"world2: each gloo rank on its half of the batch: " +
          json.dumps(steps))
    shutil.rmtree(job, ignore_errors=True)
    b1 = dict(a["b1_launches"])
    for got in ranks:
        for k, v in got["b1_launches"].items():
            b1[k] += v
    return {"b2_launches": a["b2_launches"] +
            sum(g["b2_launches"] for g in ranks),
            "b1_launches": sum(b1.values()), "b1_by_variant": b1,
            "times": times, "steps": steps}


# ---- phase 15: the bench (wsunet_tpu_torch.bench)
# the subcommand's runs: (label, WSUNET_BENCH_FAST_CONV, dtype, batch);
# the other two routes run in this process (run_bench), to keep the phase
# short
BENCH_CLI_RUNS = [("bf16, B=128, B1 (the defaults)", "1", "bfloat16", 128),
                  ("f32, B=32, B1", "1", "float32", 32)]
BENCH_ROUTE_RUNS = [("bf16, B=32, borderfix", "borderfix"),
                    ("bf16, B=32, route 0", "0")]
# the headline step's shapes held in process, (dtype, batch): the
# subcommand's default batch and the batches of (b)'s B1 runs
BENCH_STEP_SHAPES = [(torch.bfloat16, 8), (torch.bfloat16, 128),
                     (torch.float32, 8), (torch.float32, 32)]
B1_VARIANTS = {torch.bfloat16: {"wgmma": 9, "direct": 1},
               torch.float32: {"fma": 9, "direct": 1}}
# where the headline's time goes, (dtype, batch, fast_conv): the default,
# f32 at (b)'s batch and at the default's, and route 0 for comparison
BENCH_PROFILES = [("bfloat16", 128, True), ("float32", 32, True),
                  ("float32", 128, True), ("bfloat16", 32, False)]
BENCH_KEYS = ("value", "flops_per_image", "tflops_per_sec",
              "fast_conv", "b1_launches_per_step", "peak_memory_gib",
              "step_ms", "latency_ms_b1", "rtt_floor_ms", "latency_ms_b1_net",
              "serial_images_per_sec", "streamed_images_per_sec",
              "stream_speedup", "ws_fused", "decode_only", "e2e_decode")
BENCH_TIMEOUT = 300


def check_bench_record(label: str, out: dict, dtype: str, route,
                       batch: int) -> None:
    """The keys and numbers of one ``run_bench`` record on the card."""
    from wsunet_tpu_torch import bench

    missing = [k for k in BENCH_KEYS if k not in out]
    check(not missing, f"bench {label}: missing {missing}")
    check(out["platform"] == "cuda" and out["fast_conv"] == route,
          f"bench {label}: {out['platform']}, fast_conv {out['fast_conv']}")
    check(out["b1_launches_per_step"] == (10 if route is True else 0),
          f"bench {label}: {out['b1_launches_per_step']} B1 launches a step")
    check(f"{dtype}, batch {batch})" in out["metric"],
          f"bench {label}: {out['metric']}")
    check(out["flops_per_image"] == bench.unet_flops(bench.SIDE) / 1e9,
          f"bench {label}: {out['flops_per_image']} GFLOP an image")
    # mfu needs the card's peak (bench._PEAK_FLOPS)
    peaked = any(k in out["device"] for k in bench._PEAK_FLOPS)
    check(out["value"] > 0 and ("mfu" in out) == peaked and
          0 < out.get("mfu", 0.5) < 1,
          f"bench {label}: {out['value']} img/s, mfu {out.get('mfu')}")
    # the floors of the configurations FLOORS holds are reported, not
    # enforced here: a card below its 700 W limit runs slower
    check(("floor_ok" in out) == ((dtype, route, batch) in bench.FLOORS
                                  and bench.FLOOR_CARD in out["device"]),
          f"bench {label}: floor keys")
    fused = out["ws_fused"]
    check(set(fused["parity_by_mode"]) ==
          {f"{k}_w{w}" for k in ("KB", "AVG") for w in (0, 1, -1)},
          f"bench {label}: ws_fused modes {sorted(fused['parity_by_mode'])}")
    # beta_hat of uniform noise lies in [0, 1]: B2's tolerance at 1
    check(fused["max_abs_diff_vs_plain"] <= ATOL + RTOL,
          f"bench {label}: B2 {fused['max_abs_diff_vs_plain']} from plain")
    check(fused["measurement_ok"] and fused["ms_per_call"] > 0,
          f"bench {label}: ws_fused window {fused['window_ms']} ms")
    # the port's PNG reader runs on the card: both sections are numbers
    for section in ("decode_only", "e2e_decode"):
        check("unavailable" not in out[section] and
              out[section].get("images", 0) > 0,
              f"bench {label}: {section} {out[section]}")


def bench_path(smi_line: str) -> dict:
    """Phase 15: (a) in this process, the bench's headline step on B1 at
    the shapes the bench gives it (``BENCH_STEP_SHAPES``), every B1 launch
    held against B1's plain version (phase 5's bounds) and counted, its
    (beta_hat, l1) against the cuDNN route's; the latency section's bf16
    server, one request; the ws_fused section at B=128, every B2 launch
    outside the CUDA graph held against B2's plain version (phase 2's
    bounds) and counted, its parity at B2's tolerance; (b) ``python -m
    wsunet_tpu_torch bench`` at the defaults (B=128) and in f32 at B=32,
    ``run_bench`` on the two other routes at B=32: the JSON records,
    their keys and numbers; (c) where the headline's time goes
    (``BENCH_PROFILES``, torch.profiler)."""
    from wsunet_tpu_torch import bench
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.serve import UNetWSServer

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    b1_calls, b2_calls = [], []
    b1_launch, b2_launch = fused_reflect_conv._launch, fused_ws._launch
    checked_b2 = checking_b2(b2_calls, "the bench's ws_fused")

    def b2_unless_capturing(x_u8, kernel_name, weighted):
        # a launch captured in the timed graph is the warm-up launch's
        # twin on the same input; the check would synchronize the capture
        if torch.cuda.is_current_stream_capturing():
            return b2_launch(x_u8, kernel_name, weighted)
        return checked_b2(x_u8, kernel_name, weighted)

    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    fused_reflect_conv._launch = checking_b1(b1_calls, "the bench's step")
    fused_ws._launch = b2_unless_capturing
    try:
        for dtype, batch in BENCH_STEP_SHAPES:
            x = torch.from_numpy(smooth_covers(batch, 512, seed=150)).to(dev)
            before = dict(fused_reflect_conv.launches_by_variant)
            beta, l1 = bench.make_step(
                bench.build_model(dtype, True, dev), dev)(x)
            got = {k: n - before[k] for k, n in
                   fused_reflect_conv.launches_by_variant.items() if n
                   - before[k]}
            want = B1_VARIANTS[dtype]
            check(got == want, f"bench step {dtype} B={batch}: B1 launches "
                               f"{got}")
            torch.cuda.empty_cache()
            beta0, l10 = bench.make_step(
                bench.build_model(dtype, False, dev), dev)(x)
            d_beta = float((beta - beta0).abs().max())
            d_l1 = (l1 - l10).abs()
            # bf16: phase 4's bf16 server against f32 (l1 absolute); f32:
            # phase 6's fast_conv=True against cuDNN (l1 relative)
            if dtype == torch.bfloat16:
                tol, d_l1 = (5e-3, 0.5), float(d_l1.max())
            else:
                tol, d_l1 = (1e-5, 1e-4), float((d_l1 / l10).max())
            check(d_beta <= tol[0] and d_l1 <= tol[1],
                  f"bench step {dtype} B={batch}: B1 against cuDNN beta "
                  f"{d_beta}, l1 {d_l1}")
            print(f"bench step B={batch} {str(dtype)[6:]} on B1: {got}, "
                  f"|d beta| {d_beta:.3e}, d l1 {d_l1:.3e} from the cuDNN "
                  f"route")
            del x, beta, l1, beta0, l10
            torch.cuda.empty_cache()
        # the latency section's server (bf16 on the headline's route): its
        # warm-up request and one more
        server = UNetWSServer(bench.build_model(torch.bfloat16, True, dev),
                              size=bench.SIDE, device=dev)
        beta, l1 = server.predict(smooth_covers(1, 512, seed=151)[0])
        check(np.isfinite([beta, l1]).all(), f"bench server: {beta}, {l1}")
        del server
        fused = bench._bench_ws_fused(dev, batch_size=128)
    finally:
        fused_reflect_conv._launch, fused_ws._launch = b1_launch, b2_launch
    b1_launches, b2_launches = fused_reflect_conv.launches, fused_ws.launches
    want_b1 = 10 * (len(BENCH_STEP_SHAPES) + 2)
    check(b1_launches == len(b1_calls) == want_b1,
          f"bench step: {b1_launches} B1 launches, {len(b1_calls)} checked")
    check(fused["max_abs_diff_vs_plain"] <= ATOL + RTOL and
          len(fused["parity_by_mode"]) == 6, f"ws_fused parity {fused}")
    check(b2_launches == len(b2_calls) + 50 and len(b2_calls) == 9,
          f"ws_fused: {b2_launches} B2 launches, {len(b2_calls)} checked")
    print(f"bench in process: B1 {b1_launches} launches (max |err| "
          f"{max(e for _, e in b1_calls):.3e}), B2 {b2_launches} "
          f"({len(b2_calls)} held to the plain version, 50 in the timed "
          f"graph); ws_fused B=128: " + json.dumps(fused))
    torch.cuda.empty_cache()

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for label, mode, dtype, batch in BENCH_CLI_RUNS:
        t0 = time.perf_counter()
        flags = ["--batch-size", str(batch)] + (
            [] if dtype == "bfloat16" else ["--dtype", dtype])
        proc = subprocess.run(
            [sys.executable, "-m", "wsunet_tpu_torch", "bench", *flags],
            cwd=REPO, env={**env, "WSUNET_BENCH_FAST_CONV": mode},
            capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        check(proc.returncode == 0, f"bench {label}: rc {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        check_bench_record(label, out, dtype, bench.ROUTES[mode], batch)
        print(f"bench {label} ({time.perf_counter() - t0:.1f} s, "
              f"{smi_line}): " + json.dumps(out))
    for label, mode in BENCH_ROUTE_RUNS:
        os.environ["WSUNET_BENCH_FAST_CONV"] = mode
        try:
            out = bench.run_bench(batch_size=32)
        finally:
            del os.environ["WSUNET_BENCH_FAST_CONV"]
        check_bench_record(label, out, "bfloat16", bench.ROUTES[mode], 32)
        print(f"bench {label} ({smi_line}): " + json.dumps(out))
    torch.cuda.empty_cache()

    # (c) where the time goes; these launches are not counted above
    rng = np.random.default_rng(0)
    for dtype, batch, route in BENCH_PROFILES:
        step = bench.make_step(
            bench.build_model(bench.DTYPES[dtype], route, dev), dev)
        x = torch.from_numpy(rng.integers(
            0, 256, (batch, bench.SIDE, bench.SIDE)).astype(np.uint8)).to(dev)
        step(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = device_profile(lambda: step(x), steps=3, top=8)
        print(f"bench profile ({smi_line}): " + json.dumps(
            {"dtype": dtype, "batch": batch, "fast_conv": route,
             "peak_memory_gib": peak,
             "images_per_sec_profiled": batch / prof["wall_ms"] * 1e3,
             **prof}))
        del step, x
        torch.cuda.empty_cache()
    return {"b1_launches": b1_launches, "b2_launches": b2_launches}


# ---- phase 16: the detection path from PNG files (io.png, utils.table)
PNG_JOB = REPO / "build" / "smoke_png"
# what the card's machine lacks: stub packages that raise ImportError go
# first on the CLI subprocesses' PYTHONPATH, so the proof holds anywhere
HOST_PACKAGES = ("pandas", "PIL", "cv2", "matplotlib", "seaborn")
CLI_TIMEOUT = 300
# the corrupt cover: phase 9's corrupt .npy file is the same image
PNG_BAD = 2
# (b): 64 covers of 512x512, each four p256 covers tiled 2x2
WIDE_COVERS = 64
WIDE_ALPHAS = ("0.1", "0.4")


def cli_checked(out: pathlib.Path, args: list) -> int:
    """``chip_smoke.py --cli-checked OUT ARGS...``: ``python -m
    wsunet_tpu_torch ARGS`` (the CLI's ``main``) in this process, under
    ``run_checked``."""
    from wsunet_tpu_torch.cli import main as cli_main

    def run():
        rc = cli_main([str(a) for a in args])
        check(rc in (0, None), f"CLI {args[0]}: exit {rc}")
    return run_checked(out, f"CLI {args[0]}", run)


def run_checked(out: pathlib.Path, label: str, fn) -> int:
    """``fn()`` in this process, each B1 and B2 launch held against its
    plain version (phases 5's and 2's bounds) and counted from 0; the
    counts, the errors and the wall time go to ``out`` (JSON).  Every
    host package must fail to import here, before and after the run."""
    import importlib

    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws

    def host_loaded() -> list:
        found = []
        for name in HOST_PACKAGES:
            try:
                importlib.import_module(name)
                found.append(name)
            except ImportError:
                pass
        return found + sorted(m for m in sys.modules
                              if m.split(".")[0] in HOST_PACKAGES)

    check(not host_loaded(), f"host packages import here: {host_loaded()}")
    b1_calls, b2_calls = [], []
    fused_reflect_conv._launch = checking_b1(b1_calls, label)
    fused_ws._launch = checking_b2(b2_calls, label)
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    check(not host_loaded(), f"{label} loaded {host_loaded()}")
    out.write_text(json.dumps({
        "wall_s": wall, "b1": fused_reflect_conv.launches,
        "b1_checked": len(b1_calls),
        "b1_by_variant": dict(fused_reflect_conv.launches_by_variant),
        "b1_max_err": max([e for _, e in b1_calls], default=0.0),
        "b2": fused_ws.launches, "b2_checked": len(b2_calls),
        "b2_max_err": max(b2_calls, default=0.0)}))
    return 0


def run_cli(job: pathlib.Path, label: str, args: list,
            mode: str = "--cli-checked") -> dict:
    """One CLI command as a subprocess of ``cli_checked`` (or another
    ``mode`` of this script that runs under ``run_checked``), where the
    host packages cannot be imported; its record, stdout and stderr."""
    stubs = job / "stubs"
    for name in HOST_PACKAGES:
        (stubs / name).mkdir(parents=True, exist_ok=True)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed here')\n")
    out = job / f"cli_{re.sub(r'[^a-z0-9]+', '_', label.lower())}.json"
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(stubs), str(REPO)])}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), mode,
         str(out), *map(str, args)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=CLI_TIMEOUT)
    check(proc.returncode == 0, f"{label}: exit {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    rec = json.loads(out.read_text())
    check(rec["b1"] == rec["b1_checked"] and rec["b2"] == rec["b2_checked"],
          f"{label}: a launch escaped the check: {rec}")
    rec.update(stdout=proc.stdout, stderr=proc.stderr,
               process_s=time.perf_counter() - t0)
    print(f"{label} (a process without {', '.join(HOST_PACKAGES)}): "
          f"{rec['process_s']:.1f} s ({rec['wall_s']:.1f} s in main); "
          f"B1 {rec['b1']} launches {json.dumps(rec['b1_by_variant'])}, "
          f"max |err| {rec['b1_max_err']:.3e}; B2 {rec['b2']}, max |err| "
          f"{rec['b2_max_err']:.3e}, each held to its plain version")
    return rec


def read_rows(path: pathlib.Path) -> list:
    """A CSV's rows as dicts of text (numbers parsed by the caller with
    ``float``, the nearest double, so a written repr reads back
    exactly)."""
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def png_catalog(root: pathlib.Path, gold) -> list:
    """The golden covers as the committed PNGs and the golden JAX stego
    written by ``io.png.write_png``, each directory with a ``files.csv``
    table, in the JAX CLI's layout; the cover names."""
    from wsunet_tpu_torch.io.png import write_png
    from wsunet_tpu_torch.utils.table import Table

    names = [str(n) for n in gold["names"]]
    (root / "images").mkdir(parents=True)
    for n in names:
        shutil.copyfile(REPO / "data_ablation" / "p128" / n, root / n)
    Table({"name": names, "height": 128, "width": 128},
          n=len(names)).to_csv(root / "images" / "files.csv")
    for s, alpha in enumerate(gold["sets"]):
        if s == 0:
            continue
        sub = f"stego_LSBr_alpha_{alpha}_independent_images"
        (root / sub).mkdir()
        rows = [f"{sub}/{pathlib.Path(n).name}" for n in names]
        for row, img in zip(rows, gold["pixels"][s]):
            write_png(root / row, img)
        Table({"name": rows, "height": 128, "width": 128,
               "stego_method": "LSBR", "alpha": float(alpha)},
              n=len(rows)).to_csv(root / sub / "files.csv")
    return names


def tile_covers(root: pathlib.Path, n: int, seed: int) -> None:
    """``n`` 512x512 covers under ``root/images``, each four p256 covers
    (drawn from ``seed``, each flipped or not on each axis) tiled 2x2,
    written by ``io.png.write_png``, with their ``files.csv``."""
    from wsunet_tpu_torch.io.imread import imread_gray_u8
    from wsunet_tpu_torch.io.png import write_png
    from wsunet_tpu_torch.utils.table import Table

    src = sorted((REPO / "data_ablation" / "p256" / "images").glob("*.png"))
    p256 = [imread_gray_u8(p) for p in src]
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    names = [f"images/c{i:02d}.png" for i in range(n)]
    for name in names:
        quads = []
        for k in rng.integers(0, len(p256), 4):
            q = p256[k]
            if rng.random() < 0.5:
                q = q[::-1]
            if rng.random() < 0.5:
                q = q[:, ::-1]
            quads.append(q)
        write_png(root / name, np.block([[quads[0], quads[1]],
                                         [quads[2], quads[3]]]))
    Table({"name": names, "height": 512, "width": 512},
          n=n).to_csv(root / "images" / "files.csv")


def png_path(smi_line: str, p9: dict) -> dict:
    """Phase 16: the detection path from PNG files, the CLI as a user runs
    it, in processes where pandas, PIL, cv2, matplotlib and seaborn
    cannot be imported.  (a) On p128 against phase 9 and JAX: the covers
    decode bit for bit; ``ws-eval`` (KB, KB-w, UNet_l1ws on B1) and
    ``unet-eval --fast-conv`` give phase 9's in-memory beta_hat bit for
    bit, the corrupt cover the row its ``.npy`` gave; ``detector-eval``
    P(stego) within phase 10's bound of JAX's; ``roc --b0`` at each alpha
    within phase 9's bounds of JAX's statistics; every B1 and B2 launch of
    those processes held against its plain version.  (b) At 512x512:
    ``simulate``, ``ws-eval`` (KB, KB-w) and ``unet-eval --fast-conv``
    over 192 PNGs; decode ms an image at 1 and 8 threads, the sweeps'
    wall and img/s with the decode in the clock, the card's busy share,
    the bench's decode sections."""
    from wsunet_tpu_torch import bench
    from wsunet_tpu_torch.data import pipeline
    from wsunet_tpu_torch.io.imread import imread_gray_u8
    from wsunet_tpu_torch.io.png import PngError, library_path
    from wsunet_tpu_torch.ops import fused_reflect_conv, fused_ws
    from wsunet_tpu_torch.utils.registry import get_model_name
    from wsunet_tpu_torch.ws import unet_run, ws_run

    torch.cuda.empty_cache()
    gold, gold_b0 = np.load(GOLDEN), np.load(GOLDEN_B0)
    job = PNG_JOB
    shutil.rmtree(job, ignore_errors=True)
    clean, bad = job / "clean", job / "corrupt"
    t0 = time.perf_counter()
    names = png_catalog(clean, gold)
    sets = [str(x) for x in gold["sets"]]
    alphas = sets[1:]
    print(f"PNG catalog: {len(names)} committed p128 covers and "
          f"{len(names) * len(alphas)} golden JAX stego written by "
          f"io.png.write_png ({time.perf_counter() - t0:.2f} s); unfilter "
          f"{library_path().name}")
    # the decoded covers and stego against the golden pixels
    t0 = time.perf_counter()
    for s, label in enumerate(sets):
        sub = "images" if s == 0 else \
            f"stego_LSBr_alpha_{label}_independent_images"
        got = np.stack([imread_gray_u8(clean / sub / pathlib.Path(n).name)
                        for n in names])
        check(np.array_equal(got, gold["pixels"][s]),
              f"io.png {sub} != the golden pixels")
    print(f"io.png decodes the {3 * len(names)} p128 PNGs bit for bit "
          f"equal to the golden pixels ({time.perf_counter() - t0:.2f} s)")
    shutil.copytree(clean, bad)
    broken = bytearray((bad / names[PNG_BAD]).read_bytes())
    broken[len(broken) // 2] ^= 0x20
    (bad / names[PNG_BAD]).write_bytes(bytes(broken))
    try:
        imread_gray_u8(bad / names[PNG_BAD])
        check(False, "the corrupt PNG decoded")
    except PngError as e:
        print(f"corrupt cover {names[PNG_BAD]}: {e}")

    runs = {}
    res = job / "res"
    runs["ws-eval"] = run_cli(job, "ws-eval p128", [
        "ws-eval", "--data", bad, "--results", res, "--models", "KB",
        "KB-w", "UNet_l1ws", "--model-dir", "weights/unet", "--alphas",
        *alphas, "--fast-conv"])
    runs["unet-eval"] = run_cli(job, "unet-eval --fast-conv p128", [
        "unet-eval", "--data", bad, "--results", res, "--model-dir",
        "weights/unet", "--fast-conv"])
    runs["detector-eval"] = run_cli(job, "detector-eval p128", [
        "detector-eval", "--data", bad, "--results", res])
    for alpha in alphas:
        runs[f"roc {alpha}"] = run_cli(job, f"roc --b0 --alphas {alpha}", [
            "roc", "--data", clean, "--results", job / f"roc_{alpha}",
            "--alphas", alpha, "--b0"])
        check(f"roc_{alpha}.png not drawn" in runs[f"roc {alpha}"]["stderr"],
              "roc did not say that it drew no figure")

    pos = {n: i for i, n in enumerate(names)}
    keep = np.arange(len(names)) != PNG_BAD

    def set_of(row) -> int:
        return 0 if row["stego_method"] in ("", "Cover") else \
            sets.index(str(float(row["alpha"])))

    # ws-eval: beta_hat per (model, set, image), the corrupt cover dropped
    unet_label = "UNet_l1ws_LSBR"
    want = {"KB": p9["scores"]["KB"], "KB-w": p9["scores"]["KB-w"],
            unet_label: p9["est_b1"]}
    got = {k: np.full((len(sets), len(names)), np.nan) for k in want}
    rows = read_rows(res / "estimation" / "ws_sweep_LSBR.csv")
    for r in rows:
        got[r["model_name"]][set_of(r), pos[
            "images/" + pathlib.Path(r["name"]).name]] = float(r["beta_hat"])
    check(len(rows) == len(want) * (len(sets) * len(names) - 1),
          f"ws-eval wrote {len(rows)} rows")
    for k in want:
        check(np.isnan(got[k][0, PNG_BAD]),
              f"ws-eval {k}: a row for the corrupt cover")
        g, w = got[k].copy(), np.asarray(want[k], np.float64).copy()
        g[0, PNG_BAD] = w[0, PNG_BAD] = 0.0
        check(np.array_equal(g, w), f"ws-eval {k} from PNGs != phase 9's "
              f"in-memory sweep, max |d| {np.abs(g - w).max()}")
    print(f"ws-eval from PNGs (KB and KB-w on B2, {unet_label} on B1): "
          f"beta_hat of every image bit for bit phase 9's in-memory sweep; "
          f"the corrupt cover's row dropped, as from its .npy")

    # unet-eval: (beta_hat, l1) per image, a NaN row for the corrupt cover
    ub = np.full((len(sets), len(names)), np.inf, np.float32)
    ul = ub.copy()
    rows = read_rows(res / "estimation" / "ws_LSBR.csv")
    for r in rows:
        i = set_of(r), pos["images/" + pathlib.Path(r["name"]).name]
        ub[i] = np.float32(float(r["beta_hat"] or "nan"))
        ul[i] = np.float32(float(r["l1"] or "nan"))
    check(len(rows) == len(sets) * len(names), f"unet-eval: {len(rows)} rows")
    sweep = p9["sweep"]
    check(np.array_equal(ub[0], sweep[:, 0].astype(np.float32),
                         equal_nan=True) and
          np.array_equal(ul[0], sweep[:, 1].astype(np.float32),
                         equal_nan=True),
          "unet-eval covers from PNGs != phase 9's sweep from .npy")
    check(np.array_equal(ub[1:], p9["unet_b1"][0][1:]) and
          np.array_equal(ul[1:], p9["unet_b1"][1][1:]),
          "unet-eval stego from PNGs != phase 9's predict_batch")
    print("unet-eval --fast-conv from PNGs: (beta_hat, l1) of every image "
          "bit for bit phase 9's (the covers: its sweep over .npy files, "
          "the NaN row of the corrupt one included; the stego: its "
          "predict_batch)")

    # detector-eval: P(stego) against JAX's, the corrupt cover NaN
    label = str(gold_b0["labels"][0])
    prob = np.full((len(sets), len(names)), np.inf, np.float32)
    rows = read_rows(res / "detection" / "b0.csv")
    for r in rows:
        prob[set_of(r), pos["images/" + pathlib.Path(r["name"]).name]] = \
            float(r["output"] or "nan")
    want_p = gold_b0[f"prob/{label}"]
    d_p = float(np.abs(prob - want_p)[np.isfinite(prob)].max())
    check(len(rows) == len(sets) * len(names) and
          np.isnan(prob[0, PNG_BAD]) and
          np.isfinite(np.delete(prob, PNG_BAD, axis=1)).all(),
          "detector-eval: rows or NaN row wrong")
    check(d_p <= B0_ATOL, f"detector-eval from PNGs: {d_p} from JAX")
    print(f"detector-eval from PNGs ({label}): P(stego) within {d_p:.3e} "
          f"of JAX (<= {B0_ATOL}); NaN for the corrupt cover")

    # roc --b0 at each alpha against JAX's statistics (phase 9's bounds)
    n = len(names)
    bounds = {"auc": 1 / n ** 2, "wauc": 1 / n ** 2, "p_e": 1 / n,
              "pmd_5fp": 1 / n}
    stats = [str(k) for k in gold["stats"]]
    table = []
    for a, alpha in enumerate(alphas):
        rows = {r["model_name"]: r for r in read_rows(
            job / f"roc_{alpha}" / "detection" / f"auc_{alpha}.csv")}
        ref = [(str(d), gold["roc"][a, i]) for i, d in
               enumerate(gold["detectors"])] + \
            [(str(d), gold_b0["roc"][a, i]) for i, d in
             enumerate(gold_b0["detectors"]) if str(d) != "OLS"]
        for det, want_row in ref:
            row = {"alpha": alpha, "detector": det}
            for key, bound in bounds.items():
                got_v = float(rows[det][key])
                want_v = float(want_row[stats.index(key)])
                row[key], row[key + "_jax"] = got_v, want_v
                check(abs(got_v - want_v) <= bound + 1e-12,
                      f"roc {det} alpha {alpha}: {key} {got_v} against JAX "
                      f"{want_v} (bound {bound})")
            table.append(row)
    print(f"roc --b0 from PNGs ({smi_line}), card (JAX): " + "; ".join(
        f"{r['detector']} a={r['alpha']}: AUC {r['auc']:.6f} "
        f"({r['auc_jax']:.6f}) P_E {r['p_e']:.6f} ({r['p_e_jax']:.6f}) "
        f"wAUC {r['wauc']:.6f} ({r['wauc_jax']:.6f}) PMD5FP "
        f"{r['pmd_5fp']:.6f} ({r['pmd_5fp_jax']:.6f})" for r in table))
    print("roc from PNGs: every AUC and wAUC within 1/4096 of JAX's, P_E "
          "and P_MD@5%FP within 1/64")

    # (b) full width: 64 covers of 512x512 and their LSBr stego as PNGs
    wide = job / "wide"
    t0 = time.perf_counter()
    tile_covers(wide, WIDE_COVERS, seed=160)
    print(f"{WIDE_COVERS} 512x512 covers, each four p256 covers tiled 2x2, "
          f"written by io.png.write_png in {time.perf_counter() - t0:.2f} s")
    runs["simulate"] = run_cli(job, "simulate 512", [
        "simulate", "--data", wide, "--method", "LSBr", "--alphas",
        *WIDE_ALPHAS])
    wres = job / "wide_res"
    runs["ws-eval 512"] = run_cli(job, "ws-eval 512", [
        "ws-eval", "--data", wide, "--results", wres, "--models", "KB",
        "KB-w", "--alphas", *WIDE_ALPHAS])
    runs["unet-eval 512"] = run_cli(job, "unet-eval --fast-conv 512", [
        "unet-eval", "--data", wide, "--results", wres, "--model-dir",
        "weights/unet", "--fast-conv"])
    n_wide = WIDE_COVERS * (1 + len(WIDE_ALPHAS))
    rows = read_rows(wres / "estimation" / "ws_sweep_LSBR.csv")
    check(len(rows) == 2 * n_wide and
          all(np.isfinite(float(r["beta_hat"])) for r in rows),
          f"ws-eval 512: {len(rows)} rows")
    for alpha in WIDE_ALPHAS:
        kb = [float(r["beta_hat"]) for r in rows if r["model_name"] == "KB"
              and r["alpha"] and float(r["alpha"]) == float(alpha)]
        check(len(kb) == WIDE_COVERS and
              abs(np.mean(kb) - float(alpha) / 2) < 0.05,
              f"ws-eval 512 KB alpha {alpha}: mean {np.mean(kb)}")
    rows = read_rows(wres / "estimation" / "ws_LSBR.csv")
    check(len(rows) == n_wide and
          all(np.isfinite(float(r["beta_hat"])) for r in rows),
          f"unet-eval 512: {len(rows)} rows")
    b1_cli = sum(r["b1"] for r in runs.values())
    b2_cli = sum(r["b2"] for r in runs.values())
    check(runs["ws-eval"]["b2"] and runs["ws-eval"]["b1"] and
          runs["unet-eval"]["b1"] and runs["roc 0.1"]["b2"] and
          runs["ws-eval 512"]["b2"] and runs["unet-eval 512"]["b1"],
          "a kernel of the PNG path did not launch")

    # the times, in this process, without the per-launch check
    fused_reflect_conv.reset_launches()
    fused_ws.reset_launches()
    run = get_model_name(REPO / "weights" / "unet", "LSBR")
    times = {}
    for label, fn in (
            ("ws-eval KB", lambda: [ws_run(wide, m, a, "KB") for m, a in
                                    [(None, None)] + [("LSBR", float(x))
                                                      for x in WIDE_ALPHAS]]),
            ("ws-eval KB-w", lambda: [ws_run(wide, m, a, "KB-w")
                                      for m, a in [(None, None)] +
                                      [("LSBR", float(x))
                                       for x in WIDE_ALPHAS]]),
            ("unet-eval f32 on B1", lambda: unet_run(
                wide, REPO / "weights" / "unet", "LSBR", model_name=run,
                fast_conv=True))):
        walls = []
        for _ in range(2):
            pipeline.clear_decode_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        pipeline.clear_decode_cache()
        prof = device_profile(
            lambda: (pipeline.clear_decode_cache(), fn()), steps=1)
        times[label] = {"wall_s": walls, "images": n_wide,
                        "images_per_sec": [n_wide / w for w in walls],
                        "busy_share": prof["busy_share"],
                        "busy_ms": prof["busy_union_ms"],
                        "profiled_wall_ms": prof["wall_ms"]}
        print(f"sweep from PNGs, decode in the clock ({smi_line}), {label}, "
              f"{n_wide} 512x512 images at batch 8: " +
              json.dumps(times[label]))
    pipeline.clear_decode_cache()
    only = bench._bench_decode_only(wide, threads=8)
    print(f"bench decode_only, {WIDE_COVERS} 512x512 covers ({smi_line}): "
          + json.dumps(only))
    check("unavailable" not in only and only["decode_ms_per_img"] > 0 and
          only["decode_ms_per_img_threads"] > 0, f"decode_only {only}")
    e2e = bench._bench_e2e_decode(
        bench.build_model(torch.bfloat16, True, torch.device("cuda")), wide)
    print(f"bench e2e_decode, {n_wide} 512x512 PNGs, bf16 unet_2 on B1 "
          f"({smi_line}): " + json.dumps(e2e))
    check(e2e["png_images_per_sec"] > 0 and e2e["sweep_images_per_sec"] > 0,
          f"e2e_decode {e2e}")
    b1_timed, b2_timed = fused_reflect_conv.launches, fused_ws.launches
    print(f"PNG path: B1 {b1_cli} and B2 {b2_cli} launches in the CLI "
          f"processes, each held to its plain version; {b1_timed} B1 and "
          f"{b2_timed} B2 launches in the timed runs, unchecked")
    pipeline.clear_decode_cache()
    return {"b1_launches": b1_cli + b1_timed, "b2_launches": b2_cli +
            b2_timed, "b1_checked": b1_cli, "b2_checked": b2_cli,
            "b1_max_err": max(r["b1_max_err"] for r in runs.values()),
            "b2_max_err": max(r["b2_max_err"] for r in runs.values())}


# ---- phase 17: the holdout tables and the analyses from PNG files
ANALYSES_JOB = REPO / "build" / "smoke_holdout_analyses"
# (a): the golden sets' alphas, two folds of data_ablation/p128's splits
HOLDOUT_ALPHAS = ("0.1", "0.01")
HOLDOUT_B0 = "B0_mix0.1-0.05-0.01"
# per-image scores against JAX's golden ones: B2's bounds (KB, KB-w),
# phase 9's U-Net bound (beta_hat, f32 on cuDNN), B0's (P(stego))
HOLDOUT_SCORE_TOL = {"KB": (RTOL, ATOL), "KB-w": (RTOL, ATOL),
                     "UNet": (0.0, 1e-5), HOLDOUT_B0: (0.0, B0_ATOL)}
# (b): the correlation table's columns, in the JAX CLI's order
CORRELATION_COLUMNS = ["Unnamed: 0", "1", "AVG9", "AVG", "KB",
                       "UNet_dropout_l1", "UNet_LSBR_l1ws",
                       "UNet_HILLR_l1ws"]


def holdout_folds() -> list:
    """The two folds of phase 17 (a), as ``tests/test_torch_ci_holdout.py``
    makes them: fold 0 evaluates the 16 covers of ``split_va.csv``, fold 1
    the other 48 of ``split_tr.csv``; each fold's U-Net is the committed
    LSBR ``unet_2`` run, its B0 the strided LSBR B0 run."""
    from wsunet_tpu_torch.detect import Fold
    from wsunet_tpu_torch.utils.registry import get_model_name

    unets = REPO / "weights" / "unet"
    run = get_model_name(unets, "LSBR")
    return [Fold(eval_split=f"eval_fold{i}.csv",
                 unets={"UNet": (unets / "LSBR", run)},
                 b0s={HOLDOUT_B0: {"model_dir": REPO / "weights" / "b0",
                                   "stego_method": "LSBR",
                                   "model_name": B0_RUNS["strided"]}})
            for i in (0, 1)]


def holdout_checked(out: pathlib.Path, args: list) -> int:
    """``chip_smoke.py --holdout-checked OUT DATA RESULTS``:
    ``detect.holdout_roc`` over DATA's two folds (KB and KB-w on B2, the
    U-Net, B0) at the golden alphas, its files under RESULTS, under
    ``run_checked``."""
    from wsunet_tpu_torch.detect import holdout_roc

    data, results = (pathlib.Path(a) for a in args)
    return run_checked(out, "holdout_roc", lambda: holdout_roc(
        data, holdout_folds(), results_dir=results,
        filter_models=("KB", "KB-w"), stego_methods=("LSBR",),
        alphas=tuple(float(a) for a in HOLDOUT_ALPHAS)))


def golden_scores(names: list):
    """The per-image scores of JAX's golden files as the rows
    ``holdout_frames`` gives (cover rows "Cover" at alpha 0): beta_hat of
    KB, KB-w and the U-Net, clipped at 0 as the sweep clips it (the golden
    U-Net's is not), and P(stego) of the strided B0."""
    from wsunet_tpu_torch.utils.table import Table, concat

    gold, gold_b0 = np.load(GOLDEN), np.load(GOLDEN_B0)
    sets = [str(x) for x in gold["sets"]]
    parts = []
    for det in HOLDOUT_SCORE_TOL:
        vals = gold_b0[f"prob/{det}"] if det == HOLDOUT_B0 else \
            np.clip(gold[f"beta/{det}"], 0, None)
        for s, label in enumerate(sets):
            rows = names if s == 0 else [
                f"stego_LSBr_alpha_{label}_independent_images/"
                f"{pathlib.Path(n).name}" for n in names]
            parts.append(Table({
                "name": rows, "model_name": det,
                "stego_method": "Cover" if s == 0 else "LSBR",
                "alpha": 0.0 if s == 0 else float(label),
                "score" if det == HOLDOUT_B0 else "beta_hat":
                    np.asarray(vals[s], np.float64)}, n=len(names)))
    return concat(parts)


def holdout_path(job: pathlib.Path, smi_line: str) -> dict:
    """Phase 17 (a): ``holdout_roc`` on the p128 PNG covers and golden
    stego of phase 16 (a), in a process without the host packages; its
    per-image scores against JAX's golden ones, its AUC and CI files the
    port's tables of those scores read back, and within one near-tie of
    the tables of JAX's golden scores."""
    from wsunet_tpu_torch.detect import bootstrap_roc_cis, produce_roc
    from wsunet_tpu_torch.detect import ci as ci_mod
    from wsunet_tpu_torch.detect.roc import AUC_COLUMNS, TAUS
    from wsunet_tpu_torch.utils.table import Table, concat, read_csv

    data = job / "p128"
    names = [str(n) for n in np.load(GOLDEN)["names"]]
    if (PNG_JOB / "clean").is_dir():
        shutil.copytree(PNG_JOB / "clean", data)
    else:   # phase 17 run alone
        png_catalog(data, np.load(GOLDEN))
    split = REPO / "data_ablation" / "p128"
    va = set(read_csv(split / "split_va.csv")["name"])
    tr = set(read_csv(split / "split_tr.csv")["name"])
    check(va < tr and tr == set(names), "p128's splits do not hold the "
          "golden covers")
    rows = concat([read_csv(f) for f in sorted(data.glob("*/files.csv"))])
    cover_of = np.array(["images/" + pathlib.Path(n).name
                         for n in rows["name"]], object)
    for i, members in enumerate((va, tr - va)):
        rows[np.isin(cover_of, sorted(members))].to_csv(
            data / f"eval_fold{i}.csv")
    results = job / "holdout"
    rec = run_cli(job, "holdout_roc p128", [data, results],
                  mode="--holdout-checked")
    check(rec["b2"] > 0, "holdout_roc: B2 did not launch")
    det_dir = results / "detection"
    suffix = f"{min(HOLDOUT_ALPHAS, key=float)}_holdout"

    # the per-image scores against JAX's golden ones
    written = read_rows(det_dir / "scores_holdout.csv")
    card = Table({"name": [r["name"] for r in written],
                  "fold": [r["fold"] for r in written],
                  "model_name": [r["model_name"] for r in written],
                  "stego_method": [r["stego_method"] for r in written],
                  "alpha": [float(r["alpha"]) for r in written],
                  "beta_hat": [float(r["beta_hat"] or "nan")
                               for r in written],
                  "score": [float(r["score"] or "nan") for r in written]})
    gold = golden_scores(names)
    key = {(m, n): i for i, (m, n) in enumerate(zip(gold["model_name"],
                                                    gold["name"]))}
    check(len(card) == len(gold) and all(
        (m, n) in key for m, n in zip(card["model_name"], card["name"])),
        f"holdout scores: {len(card)} rows, {len(gold)} golden")
    order = np.array([key[m, n] for m, n in zip(card["model_name"],
                                                card["name"])])
    for det, (rtol, atol) in HOLDOUT_SCORE_TOL.items():
        col = "score" if det == HOLDOUT_B0 else "beta_hat"
        sel = card["model_name"] == det
        got, want = card[col][sel], gold[col][order[sel]]
        d = float(np.abs(got - want).max())
        check(np.allclose(got, want, rtol=rtol, atol=atol),
              f"holdout {det}: scores {d} from JAX's golden ones")
        folds = set(card["fold"][sel])
        check(folds == ({"all"} if det.startswith("KB") else
                        {"fold0", "fold1"}), f"holdout {det}: folds {folds}")
        print(f"holdout_roc {det}: {int(sel.sum())} per-image scores within "
              f"{d:.3e} of JAX's golden ones (rtol {rtol}, atol {atol})")

    # the written AUC and CI files are the port's tables of those scores
    card = card.drop("fold")
    files = {"auc": det_dir / f"auc_{suffix}.csv",
             "ci": det_dir / f"auc_{suffix}_ci.csv"}
    got = {"auc": produce_roc(card)[AUC_COLUMNS].drop_duplicates(),
           "ci": bootstrap_roc_cis(card)}
    for k, f in files.items():
        check(f.read_text() == got[k].to_csv(),
              f"holdout: {f.name} is not the table of its scores")
    for name in (f"roc_{suffix}.csv", "auc_by_alpha_holdout.csv"):
        check(len(read_csv(det_dir / name)) > 0, f"holdout {name} empty")

    # within one near-tie of the tables of JAX's golden scores, taken in
    # the written rows' order (the bootstrap resamples rows by position).
    # A statistic moves only where an image's score falls on the other side
    # of a grid threshold (or of 0.5) or a cover-stego pair orders the
    # other way: with no such near-tie a detector's rows are equal, bit for
    # bit, but for wAUC and P_MD@5%FP (a pair's and a cover's weight);
    # with d of them the AUC (the CI's ends) within 2 d c / n_covers and
    # P_E within d c / n_covers, c = 1 (c = the most copies of one image
    # in a resample)
    n_c = len(names)
    n_s = n_c * len(HOLDOUT_ALPHAS)
    gold = gold[order]
    want = {"auc": produce_roc(gold)[AUC_COLUMNS].drop_duplicates(),
            "ci": bootstrap_roc_cis(gold)}
    rng = np.random.default_rng(ci_mod.SEED)
    copies = max(ci_mod._counts(rng, ci_mod.N_BOOT, n).max()
                 for n in (n_s, n_c))
    ties, worst = {}, {}
    for det in HOLDOUT_SCORE_TOL:
        col = "score" if det == HOLDOUT_B0 else "beta_hat"
        sel = card["model_name"] == det
        a, b = card[col][sel], gold[col][sel]
        cover = card["stego_method"][sel] == "Cover"
        moved = ((a[:, None] > TAUS) != (b[:, None] > TAUS)).any(1) | \
            ((a > 0.5) != (b > 0.5))
        swapped = np.sign(a[~cover][:, None] - a[cover]) != \
            np.sign(b[~cover][:, None] - b[cover])
        moved[np.flatnonzero(~cover)[swapped.any(1)]] = True
        moved[np.flatnonzero(cover)[swapped.any(0)]] = True
        ties[det] = int(moved.sum())
    for k in ("auc", "ci"):
        check(list(got[k]["model_name"]) == list(want[k]["model_name"]),
              f"holdout {k}: detectors {list(got[k]['model_name'])}")
        c = 1 if k == "auc" else copies
        for i, det in enumerate(got[k]["model_name"]):
            d = ties[det]
            for col in got[k].columns[2:]:
                g, w = got[k][col][i], want[k][col][i]
                if col == "wauc":
                    bound = 2 / (n_c * n_s) * max(d, 1)
                elif col == "pmd_5fp":
                    bound = max(d, 1) / n_c
                elif col.startswith("auc"):
                    bound = 2 * d * c / n_c
                elif col.startswith("p_e"):
                    bound = d * c / n_c
                else:
                    bound = 0.0 if not d else np.inf
                dd = abs(g - w)
                worst[col] = max(worst.get(col, 0.0), float(dd))
                check(dd <= bound or (np.isnan(g) and np.isnan(w)),
                      f"holdout {k} {det} {col}: {g} against JAX's {w} "
                      f"({d} near-ties, bound {bound})")
    check(list(got["ci"]["n_cover"]) == [n_c] * 4 and
          list(got["ci"]["n_stego"]) == [n_s] * 4, "holdout CI class sizes")
    auc, ci = got["auc"], got["ci"]
    print(f"holdout_roc tables ({smi_line}): " + "; ".join(
        f"{m}: AUC {a:.6f} [{lo:.6f}, {hi:.6f}] P_E {p:.6f} "
        f"[{plo:.6f}, {phi:.6f}]" for m, a, p, lo, hi, plo, phi in zip(
            auc["model_name"], auc["auc"], auc["p_e"], ci["auc_lo"],
            ci["auc_hi"], ci["p_e_lo"], ci["p_e_hi"])))
    print("holdout_roc: the AUC and CI files are the port's tables of its "
          "own per-image scores, byte for byte, and within their near-ties "
          f"({json.dumps(ties)}; a resample draws an image up to {copies:g} "
          "times) of the tables of JAX's golden scores (max |d| " +
          json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}) +
          ")")
    return rec


def stem_split(name: str, fractions=(0.6, 0.2, 0.2)) -> str:
    """The split ``init-dataset`` puts a cover in, recomputed here: the
    sha256 of its stem mod 2^31, its last six digits as a fraction."""
    import hashlib

    seed = int(hashlib.sha256(pathlib.Path(name).stem.encode("utf-8"))
               .hexdigest(), 16) % 2 ** 31
    u = (seed % 10 ** 6) / 10 ** 6
    return "tr" if u < fractions[0] else \
        "va" if u < fractions[0] + fractions[1] else "te"


def session_path(job: pathlib.Path, smi_line: str) -> dict:
    """Phase 17 (b): a user's analysis session at 512x512 on the 64 covers
    of phase 16 (b), copied to a fresh folder, each command a process
    without the host packages."""
    from wsunet_tpu_torch.analyses.saliency import sobel_locations
    from wsunet_tpu_torch.io.imread import imread_gray_u8
    from wsunet_tpu_torch.io.png import read_png
    from wsunet_tpu_torch.utils.table import read_csv

    wide = PNG_JOB / "wide"
    if len(list((wide / "images").glob("*.png"))) != WIDE_COVERS:
        # phase 17 run alone: phase 16 (b)'s covers
        shutil.rmtree(wide, ignore_errors=True)
        tile_covers(wide, WIDE_COVERS, seed=160)
    root = job / "session"
    (root / "images").mkdir(parents=True)
    covers = sorted((wide / "images").glob("*.png"))
    for p in covers:
        shutil.copyfile(p, root / "images" / p.name)
    image = "images/" + covers[0].name
    res = job / "session_res"
    model = ["--model-dir", "weights/unet"]
    runs = {}
    for label, args in (
            ("init-dataset", ["init-dataset", "--data", root]),
            ("simulate", ["simulate", "--data", root, "--method", "LSBr",
                          "--alphas", "1.0"]),
            ("correlation", ["correlation", "--data", root, "--results",
                             res, "--fast-conv", *model]),
            ("error-boxes", ["error-boxes", "--data", root, "--results",
                             res, "--fast-conv", *model]),
            ("contour", ["contour", "--data", root, "--results", res,
                         "--fast-conv", "--image", image, *model]),
            ("saliency", ["saliency", "--data", root, "--results", res,
                          "--fast-conv", "--image", image])):
        runs[label] = run_cli(job, f"{label} 512", args)

    # init-dataset: the catalog and the stem-hash partition
    files = read_csv(root / "images" / "files.csv")
    names = ["images/" + p.name for p in covers]
    h, w = imread_gray_u8(covers[0]).shape
    check(list(files["name"]) == names and
          set(files["height"]) == {h} and set(files["width"]) == {w},
          "init-dataset: files.csv")
    parts = {w: list(read_csv(root / f"split_{w}.csv")["name"])
             for w in ("tr", "va", "te")}
    for w, got in parts.items():
        check(got == [n for n in names if stem_split(n) == w],
              f"init-dataset: split_{w}.csv is not the stem-hash split")
    print(f"init-dataset: {len(names)} covers split "
          f"{json.dumps({w: len(v) for w, v in parts.items()})}, as the "
          f"stem hash recomputed here puts them")

    # correlation.csv and ae_boxes_3.csv read back
    corr = read_csv(res / "estimation" / "correlation.csv")
    check(corr.columns == CORRELATION_COLUMNS and
          list(corr["Unnamed: 0"]) == ["correlation", "p-value"],
          f"correlation.csv: {corr.columns}")
    vals = np.array([corr[c] for c in CORRELATION_COLUMNS[1:]])
    check(np.isfinite(vals).all() and (np.abs(vals[:, 0]) <= 1).all() and
          ((vals[:, 1] >= 0) & (vals[:, 1] <= 1)).all(),
          f"correlation.csv values {vals}")
    print(f"correlation.csv ({len(names)} pairs at 512x512, alpha 1.0, "
          f"--fast-conv), median correlation: " + ", ".join(
              f"{c} {v:.6f}" for c, v in zip(CORRELATION_COLUMNS[1:],
                                             vals[:, 0])))
    boxes = read_csv(res / "prediction" / "ae_boxes_3.csv")
    stats = np.array([boxes[c] for c in boxes.columns[2:]])
    check(set(boxes["Type"]) == {"KB", "AVG", "UNet_l1", "UNet_l1ws"} and
          np.isfinite(stats).all() and
          (np.diff(stats[[0, 2, 3, 4, 6]], axis=0) >= 0).all(),
          "ae_boxes_3.csv")
    print(f"ae_boxes_3.csv: {len(boxes)} buckets over the "
          f"{len(parts['te'])} covers of split_te, each min <= q25 <= q50 "
          f"<= q75 <= max")

    # each figure not drawn named on stderr; the dots image
    stem = covers[0].stem
    for label, figs in (("error-boxes", ["ae_boxes_3.png"]),
                        ("contour", [f"contour_KB_{stem}.png",
                                     f"contour_unet_{stem}.png"]),
                        ("saliency", ["saliency_LSBR.png"])):
        for fig in figs:
            check(f"{fig} not drawn" in runs[label]["stderr"],
                  f"{label}: {fig} not named on stderr")
    check([p.name for p in res.rglob("*.png")] ==
          ["saliency_image_dots.png"], "a figure was drawn, or no dots")
    dots = read_png(res / "prediction" / "saliency_image_dots.png")
    want = np.repeat(imread_gray_u8(root / image)[..., None], 3, axis=-1)
    for loc in sobel_locations(root / image).values():
        want[loc[:2]] = [255, 0, 0]
    check(np.array_equal(dots, want),
          "saliency_image_dots.png != the image with red dots")
    print("figures not drawn (no matplotlib), each named on stderr: "
          "ae_boxes_3.png, both contours, saliency_LSBR.png; "
          "saliency_image_dots.png decodes to the image with red pixels "
          "at sobel_locations")

    # B1's launches by variant: f32 forwards, 9 fma + 1 direct each
    for label in ("correlation", "error-boxes", "contour", "saliency"):
        v = runs[label]["b1_by_variant"]
        check(v["fma"] > 0 and v["fma"] == 9 * v["direct"] and
              v["wgmma"] == 0, f"{label}: B1 launches {v}")
    check(runs["correlation"]["b1_by_variant"]["direct"] ==
          3 * -(-len(names) // 8),
          "correlation: not one B1 forward a batch of 8 for each U-Net")
    return runs


def holdout_analyses_path(smi_line: str) -> dict:
    """Phase 17: the holdout tables and the analyses from PNG files, each
    in a process where pandas, PIL, cv2, matplotlib and seaborn cannot be
    imported, every B1 and B2 launch held to its plain version and
    counted.  (a) ``holdout_roc`` on p128; (b) the analysis session at
    512x512."""
    job = ANALYSES_JOB
    shutil.rmtree(job, ignore_errors=True)
    job.mkdir(parents=True)
    t0 = time.perf_counter()
    runs = {"holdout_roc": holdout_path(job, smi_line)}
    print(f"phase 17 (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs.update(session_path(job, smi_line))
    print(f"phase 17 (b): {time.perf_counter() - t0:.1f} s")
    b1 = sum(r["b1"] for r in runs.values())
    b2 = sum(r["b2"] for r in runs.values())
    by_variant = {k: sum(r["b1_by_variant"][k] for r in runs.values())
                  for k in ("wgmma", "direct", "fma")}
    out = {"b1_launches": b1, "b2_launches": b2,
           "b1_by_variant": by_variant,
           "b1_max_err": max(r["b1_max_err"] for r in runs.values()),
           "b2_max_err": max(r["b2_max_err"] for r in runs.values()),
           "process_s": {k: round(r["process_s"], 2)
                         for k, r in runs.items()}}
    print(f"phase 17 ({smi_line}): B1 {b1} launches "
          f"{json.dumps(by_variant)}, max |err| {out['b1_max_err']:.3e}; "
          f"B2 {b2} launches, max |err| {out['b2_max_err']:.3e}; each held "
          f"to its plain version; process seconds " +
          json.dumps(out["process_s"]))
    return out


# ---- phase 18: kernel B3 (ops.fused_mbconv_dw)

B3_BATCH = 32


def b3_library(x, w, dw, ex, stride):
    """The library yardstick of B3: the composition the B0 module ran
    before B3, as PyTorch's own calls (cuDNN's batch norm, SiLU, the SAME
    pad, conv_depthwise2d, the mean)."""
    from wsunet_tpu_torch.models.b0 import _same_pad

    def bn(h, n):
        return F.batch_norm(h, n.mean, n.var, n.weight, n.bias, False, 0.0,
                            n.eps)

    if ex is not None:
        x = F.silu(bn(x, ex))
    k = w.shape[-1]
    x = _same_pad(x, k, stride) if stride != 1 else F.pad(x, [k // 2] * 4)
    y = F.silu(bn(F.conv2d(x, w, stride=stride, groups=x.shape[1]), dw))
    return y, y.mean(dim=(2, 3))


def b3_path(smi_line: str) -> dict:
    """Phase 18: B3 at each depthwise stage of B0 without stem stride,
    512x512, B=32 (see the module docstring)."""
    from wsunet_tpu_torch.models.b0 import dw_shapes
    from wsunet_tpu_torch.ops import fused_mbconv_dw as b3
    from wsunet_tpu_torch.ops.fused_mbconv_dw import BatchNormStats

    def norm(C, g):
        return BatchNormStats(
            torch.rand(C, device="cuda", generator=g) + 0.5,
            torch.randn(C, device="cuda", generator=g),
            torch.randn(C, device="cuda", generator=g),
            torch.rand(C, device="cuda", generator=g) * 1.5 + 0.5, 1e-3)

    rows, max_y, max_s = [], 0.0, 0.0
    b3.reset_launches()
    with torch.no_grad():
        for i, (C, H, k, stride, pro) in enumerate(
                dw_shapes(512, no_stem_stride=True, quadratic_stem=True)):
            g = torch.Generator(device="cuda").manual_seed(180 + i)
            x = 2.0 * torch.randn((B3_BATCH, C, H, H), device="cuda",
                                  generator=g)
            w = torch.randn((C, 1, k, k), device="cuda", generator=g) / k
            dw, ex = norm(C, g), (norm(C, g) if pro else None)
            y, s = b3.mbconv_dw(x, w, dw, ex, stride)
            again = b3.mbconv_dw(x, w, dw, ex, stride)
            want_y, want_s = b3.mbconv_dw_plain(x, w, dw, ex, stride)
            torch.cuda.synchronize()
            check(torch.equal(y, again[0]) and torch.equal(s, again[1]),
                  f"B3 block {i}: two calls differ")
            err_y = float((y - want_y).abs().max())
            err_s = float(((s - want_s).abs() /
                           want_y.abs().sum(dim=(2, 3))).max())
            check(bool(((y - want_y).abs() <=
                        1e-5 * want_y.abs() + 1e-5).all()),
                  f"B3 block {i}: y max |err| {err_y}")
            check(err_s <= 6.2e-5, f"B3 block {i}: s err {err_s} of sum|y|")
            gy = graph_output(
                lambda t: b3.mbconv_dw(t, w, dw, ex, stride)[0], x)
            check(torch.equal(gy, y), f"B3 block {i}: graph replay differs")
            del again, want_y, want_s, gy
            max_y, max_s = max(max_y, err_y), max(max_s, err_s)
            cost = b3.mbconv_dw_cost(B3_BATCH, C, H, H, k, stride, pro)
            row = {"block": i, "C": C, "H": H, "k": k, "stride": stride,
                   "prologue": pro, "plan": list(b3._plan(
                       B3_BATCH, C, H, H, k, stride)),
                   "bound_ms": 1e3 * cost["bytes"] / HBM_BYTES_PER_S}
            for key, fn in (
                    ("ms", lambda t: b3.mbconv_dw(t, w, dw, ex, stride)),
                    ("plain_ms",
                     lambda t: b3.mbconv_dw_plain(t, w, dw, ex, stride)),
                    ("library_ms",
                     lambda t: b3_library(t, w, dw, ex, stride))):
                row[key] = graph_ms(fn, [x], reps=5, iters=10)
            row["roofline"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            print(f"B3 block {i:2d} C={C:4d} {H}^2 k={k} s={stride} "
                  f"prologue={int(pro)} plan={row['plan']}: "
                  f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
                  f"{100 * row['roofline']:.1f}%), plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}",
                  flush=True)
            del x, y, s
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
    print(f"phase 18 ({smi_line}): B3 over the 16 blocks at B={B3_BATCH}, "
          f"512^2: {total['ms']:.3f} ms (bound {total['bound_ms']:.3f}: "
          f"{100 * total['bound_ms'] / total['ms']:.1f}% of the roofline); "
          f"plain {total['plain_ms']:.3f} ms; library "
          f"{total['library_ms']:.3f} ms; max |err| y {max_y:.3e}, s "
          f"{max_s:.3e} of sum|y|; {b3.launches} launches outside graphs")
    return {"rows": rows, "total": total, "max_err_y": max_y,
            "max_err_s": max_s}


def b3_only() -> int:
    """``--b3``: the device line, the kernel build with ptxas' report of
    B3, and phase 18."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from wsunet_tpu_torch._device import disable_tf32
    from wsunet_tpu_torch.ops import _cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {line}")
    disable_tf32()
    t = time.perf_counter()
    _cuda_build.load_all(_cuda_build.SOURCES)
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    for ptx in ptxas_lines(_cuda_build.build_info("mbconv_dw")["log"]):
        print("  ptxas: " + ptx)
    out = b3_path(line)
    print(json.dumps({"b3": out["total"], "max_err_y": out["max_err_y"],
                      "max_err_s": out["max_err_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---- phase 19: kernel B4 (ops.fused_gdfn_gate)

B4_BATCH = 32
# B4 against its plain version: each output may sum its 9 products a half
# in another order (a few ulps of values of order 1 at these inputs), then
# the same erff and product (0.0 seen on the H100); a tanh GELU would
# differ by up to 4.7e-4
B4_RTOL, B4_ATOL = 1e-5, 2e-5


def b4_library(dwconv, u):
    """The library yardstick of B4: the GDFN's middle as the model ran it
    before B4 (the module's grouped conv, ``chunk``, exact GELU and the
    product)."""
    x1, x2 = dwconv(u).chunk(2, dim=1)
    return F.gelu(x1) * x2


def b4_path(smi_line: str) -> dict:
    """Phase 19: B4 at the shapes of a Restormer forward, 512x512, B=32
    (see the module docstring)."""
    from wsunet_tpu_torch.models import get_model
    from wsunet_tpu_torch.models.restormer import gate_shapes, init_restormer
    from wsunet_tpu_torch.ops import fused_gdfn_gate as b4

    torch.cuda.empty_cache()
    shapes = gate_shapes(512)
    rows, max_err = [], 0.0
    b4.reset_launches()
    with torch.no_grad():
        for i, (h, H) in enumerate(dict.fromkeys(shapes)):
            n = shapes.count((h, H))
            g = torch.Generator(device="cuda").manual_seed(190 + i)
            u = torch.randn((B4_BATCH, 2 * h, H, H), device="cuda",
                            generator=g)
            dwconv = torch.nn.Conv2d(2 * h, 2 * h, 3, padding=1,
                                     groups=2 * h, bias=False).cuda()
            dwconv.weight.copy_(torch.randn(dwconv.weight.shape,
                                            device="cuda", generator=g) / 3)
            w = dwconv.weight
            y = b4.gdfn_gate(u, w)
            again = b4.gdfn_gate(u, w)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"B4 {h}x{H}^2: two calls differ")
            del again
            err = 0.0
            for a in range(0, B4_BATCH, 4):
                want = b4.gdfn_gate_plain(u[a:a + 4], w)
                diff = (y[a:a + 4] - want).abs()
                err = max(err, float(diff.max()))
                check(bool((diff <= B4_RTOL * want.abs() + B4_ATOL).all()),
                      f"B4 {h}x{H}^2: max |err| {err}")
            del want, diff
            gy = graph_output(lambda t: b4.gdfn_gate(t, w), u)
            check(torch.equal(gy, y), f"B4 {h}x{H}^2: graph replay differs")
            del gy, y
            max_err = max(max_err, err)
            cost = b4.gdfn_gate_cost(B4_BATCH, h, H, H)
            row = {"h": h, "H": H, "launches_a_forward": n,
                   "plan": list(b4._plan(H)),
                   "bound_ms": 1e3 * cost["bytes"] / HBM_BYTES_PER_S}
            for key, fn in (
                    ("ms", lambda t: b4.gdfn_gate(t, w)),
                    ("plain_ms", lambda t: b4.gdfn_gate_plain(t, w)),
                    ("library_ms", lambda t: b4_library(dwconv, t))):
                row[key] = cuda_ms(fn, [u])
            row["roofline"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            print(f"B4 h={h:4d} {H}^2 x{n:2d} plan={row['plan']}: "
                  f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
                  f"{100 * row['roofline']:.1f}%), plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}; "
                  f"max |err| {err:.3e}", flush=True)
            del u, dwconv, w
    total = {key: sum(r[key] * r["launches_a_forward"] for r in rows)
             for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
    print(f"phase 19 ({smi_line}): B4 over the {len(shapes)} launches of a "
          f"forward at B={B4_BATCH}, 512^2: {total['ms']:.3f} ms (bound "
          f"{total['bound_ms']:.3f}: "
          f"{100 * total['bound_ms'] / total['ms']:.1f}% of the roofline); "
          f"plain {total['plain_ms']:.3f} ms; library "
          f"{total['library_ms']:.3f} ms; max |err| {max_err:.3e}; "
          f"{b4.launches} launches outside graphs")
    # one eval forward of the model at the cell's side and at 500^2
    # (padded to 504^2: level 3's width 126 and the latent's 63 are not
    # multiples of 4), B=1: every one of its gated FFNs takes B4
    model = init_restormer(get_model("restormer_gray"), seed=19).cuda().eval()
    forward_launches = {}
    with torch.no_grad():
        for side in (512, 500):
            x = torch.rand((1, 1, side, side), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(side))
            b4.reset_launches()
            y = model(x)
            torch.cuda.synchronize()
            forward_launches[side] = b4.launches
            check(b4.launches == len(shapes) and bool(y.isfinite().all()),
                  f"B4: an eval forward at {side}^2 took {b4.launches} "
                  f"launches, not {len(shapes)}")
    del model, x, y
    print(f"phase 19: an eval restormer_gray forward, B=1: "
          f"{forward_launches} B4 launches (side: launches)")
    return {"rows": rows, "total": total, "max_err": max_err,
            "forward_launches": forward_launches[512]}


def b4_only() -> int:
    """``--b4``: the device line, the kernel build with ptxas' report of
    B4, and phase 19."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from wsunet_tpu_torch._device import disable_tf32
    from wsunet_tpu_torch.ops import _cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {line}")
    disable_tf32()
    t = time.perf_counter()
    _cuda_build.load_all(_cuda_build.SOURCES)
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    for ptx in ptxas_lines(_cuda_build.build_info("gdfn_gate")["log"]):
        print("  ptxas: " + ptx)
    out = b4_path(line)
    print(json.dumps({"b4": out["total"], "max_err": out["max_err"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from wsunet_tpu_torch import bench
    from wsunet_tpu_torch._device import disable_tf32
    from wsunet_tpu_torch.analyses import saliency_patch
    from wsunet_tpu_torch.models import get_model, init_unet
    from wsunet_tpu_torch.ops import (NAMED_FILTERS_2D, _cuda_build,
                                      fused_reflect_conv, fused_ws,
                                      ws_attack)
    from wsunet_tpu_torch.serve import UNetWSServer, measure_latency
    from wsunet_tpu_torch.ws import (attack_batches, parse_filter_model,
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

    # ---- 2. build every kernel source; B2 against its plain version
    t_build = time.perf_counter()
    _cuda_build.load_all(_cuda_build.SOURCES)
    print(f"kernel build (nvcc, sm_90a, {len(_cuda_build.SOURCES)} sources "
          f"in parallel): {time.perf_counter() - t_build:.1f} s")
    for src in _cuda_build.SOURCES:
        build = _cuda_build.build_info(src)
        print(f"  csrc/{src}.cu: nvcc {build['seconds']:.1f} s")
        for line in ptxas_lines(build["log"]):
            print("  ptxas: " + line)
    # the PNG reader's unfilter (host code, g++), which phase 16 runs
    from wsunet_tpu_torch.io import png
    built = not png.library_path().exists()
    t_build = time.perf_counter()
    png._load()
    print(f"  csrc/png_unfilter.cpp: g++ {time.perf_counter() - t_build:.2f} s"
          f" ({'built' if built else 'already built'}: "
          f"{png.library_path().name})")
    covers = smooth_covers(128, 512, seed=1)
    mixed = covers.copy()
    mixed[1::2] = lsb_replace(covers[1::2], ALPHA, seed=2)
    rng = np.random.default_rng(3)
    mixed[::7] = rng.integers(0, 256, mixed[::7].shape, dtype=np.uint8)
    x128 = torch.from_numpy(mixed).to(dev)
    shapes = {"128x512x512": x128, "8x512x512": x128[:8].contiguous(),
              "1x512x512": x128[5:6].contiguous()}
    # ragged widths, fewer interior rows than a cluster has blocks, and
    # W % 16 != 0 (ragged band ends)
    for shape in [(3, 37, 53), (3, 3, 3), (2, 5, 130), (2, 130, 257),
                  (2, 9, 15), (2, 9, 16), (2, 9, 17), (1, 5, 130),
                  (2, 20, 130), (2, 3, 3)]:
        shapes["x".join(map(str, shape))] = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    # a base pointer 1,961 bytes into its storage (not 16-byte aligned)
    shapes["(4x37x53)[1:]"] = torch.from_numpy(
        rng.integers(0, 256, (4, 37, 53), dtype=np.uint8)).to(dev)[1:]
    max_err = 0.0
    for kname in FILTERS:
        for w in WEIGHTS:
            for shape, x in shapes.items():
                fused_ws.reset_launches()
                got = fused_ws.ws_attack_fused(x, kname, w)
                check(fused_ws.launches == 1,
                      f"B2 {kname} weighted={w} {shape}: "
                      f"{fused_ws.launches} launches")
                again = fused_ws.ws_attack_fused(x, kname, w)
                want = fused_ws.ws_attack_fused_plain(x, kname, w)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"B2 {kname} weighted={w} {shape}: two calls differ")
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                      f"B2 {kname} weighted={w} {shape}: max |err| {err}")
    print(f"B2 = plain at rtol {RTOL}, atol {ATOL} for {len(FILTERS)} "
          f"filters x {len(WEIGHTS)} weightings x {len(shapes)} shapes "
          f"({', '.join(shapes)}); one launch a call; two calls bitwise "
          f"equal; max |err| {max_err:.3e}")
    # 64-bit offsets: 8200x512x512 is 2.15e9 bytes; the last 4 images lie
    # beyond 2^31 bytes and are compared on their own slice
    g = torch.Generator(device="cuda").manual_seed(14)
    big = torch.randint(0, 256, (8200, 512, 512), dtype=torch.uint8,
                        device=dev, generator=g)
    big[-4:] = x128[:4]
    for kname in FILTERS:
        for w in WEIGHTS:
            got = fused_ws.ws_attack_fused(big, kname, w)[-4:]
            want = fused_ws.ws_attack_fused_plain(big[-4:], kname, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"B2 {kname} weighted={w} 8200x512x512 (last 4): "
                  f"max |err| {err}")
    del big
    torch.cuda.empty_cache()
    print(f"B2 = plain on the last 4 images of 8200x512x512 "
          f"({8200 * 512 * 512:,} bytes) for every filter and weighting")
    t = phase(2, "kernel build; B2 against its plain version", t)

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
            attack_batches(cover_batches, kernel_name=kname,
                           weighted=weighted),
            attack_batches(stego_batches, kernel_name=kname,
                           weighted=weighted))
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

    # ---- 5. B1 against its plain version on the card (built in phase 2)
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
    t = phase(5, "B1 against its plain version", t)

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
        patches[fc] = saliency_patch(m, sal_img, 200, 300)
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
                replayed = graph_output(kernel, bufs[0])
                check(torch.equal(replayed, kernel(bufs[0])),
                      f"B2 {kname} weighted={w} B={B}: graph replay != "
                      "eager call")
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
    print("B2: a CUDA-graph replay equals the eager call bitwise in each "
          "of the 24 cases. ms and plain_ms: device time of one call, from "
          "CUDA-graph replay; eager_ms: one call launched from Python "
          "(host-inclusive, what attack_batches pays a batch). Inputs rotate "
          "over "
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

    flop_img = bench.unet_flops(512)
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
        ("attack_batches KB, 4 numpy batches of 8 (pinned uploads)",
         lambda: attack_batches(cover_batches, kernel_name="KB"), 5),
        ("attack_batches KB, 4 CPU-tensor batches of 8 (pageable uploads)",
         lambda: attack_batches([torch.from_numpy(b) for b in cover_batches],
                                kernel_name="KB"), 5)]
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
    # the attack sweep's wall time without the profiler, by upload route
    for label, batches in (
            ("numpy batches (pinned uploads)", cover_batches),
            ("CPU tensors (pageable uploads)",
             [torch.from_numpy(b) for b in cover_batches])):
        attack_batches(batches, kernel_name="KB")
        t0 = time.perf_counter()
        for _ in range(20):
            attack_batches(batches, kernel_name="KB")
        print(f"attack_batches KB, 4 batches of 8x512x512 from {label}: "
              f"{1e3 * (time.perf_counter() - t0) / 20:.3f} ms a sweep "
              "(host clock, no profiler)")
    t = phase(8, "where the time goes", t)

    # ---- 9. the trained-weights detection path
    det = detection_path(smi.stdout.strip().splitlines()[0])
    t = phase(9, "trained-weights detection path", t)

    # ---- 10. the B0 detection path
    b0_path(smi.stdout.strip().splitlines()[0])
    t = phase(10, "B0 detection path", t)

    # ---- 11. the U-Net training path
    training_path(smi.stdout.strip().splitlines()[0])
    t = phase(11, "U-Net training path", t)

    # ---- 12. the B0 training path and filters-eval
    b0_training_path(smi.stdout.strip().splitlines()[0])
    t = phase(12, "B0 training path and filters-eval", t)

    # ---- 13. the analyses and the serving CLI
    ana = analyses_path(smi.stdout.strip().splitlines()[0])
    t = phase(13, "analyses and the serving CLI", t)

    # ---- 14. the parallel path
    par = parallel_path(smi.stdout.strip().splitlines()[0])
    t = phase(14, "parallel path", t)

    # ---- 15. the bench
    ben = bench_path(smi.stdout.strip().splitlines()[0])
    t = phase(15, "the bench", t)

    # ---- 16. the detection path from PNG files
    pngs = png_path(smi.stdout.strip().splitlines()[0], det)
    t = phase(16, "the detection path from PNG files", t)

    # ---- 17. the holdout tables and the analyses from PNG files
    hold = holdout_analyses_path(smi.stdout.strip().splitlines()[0])
    t = phase(17, "the holdout tables and the analyses from PNG files", t)

    # ---- 18. kernel B3
    b3_out = b3_path(smi.stdout.strip().splitlines()[0])
    t = phase(18, "kernel B3", t)

    # ---- 19. kernel B4
    b4_out = b4_path(smi.stdout.strip().splitlines()[0])
    t = phase(19, "kernel B4", t)

    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "ws_attack_fused",
        "route": "cuda",
        "source": "wsunet_tpu_torch/csrc/ws_fused.cu",
        "replaces": "wsunet_tpu/ops/pallas_ws.py:90",
        "launches": attack_launches,
        "launches_detection_path": det["b2_launches"],
        "launches_analyses_path": 0,
        "launches_parallel_path": par["b2_launches"],
        "launches_bench_path": ben["b2_launches"],
        "launches_png_path": pngs["b2_launches"],
        "launches_png_path_checked": pngs["b2_checked"],
        "launches_holdout_analyses_path": hold["b2_launches"],
        "max_abs_err": max(max_err, pngs["b2_max_err"], hold["b2_max_err"]),
        "ms": b2_entry["ms"],
        "eager_ms": b2_entry["eager_ms"],
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
        "launches_detection_path": det["b1_launches"],
        "launches_analyses_path": ana["b1_launches"],
        "launches_parallel_path": par["b1_launches"],
        "launches_bench_path": ben["b1_launches"],
        "launches_png_path": pngs["b1_launches"],
        "launches_png_path_checked": pngs["b1_checked"],
        "launches_holdout_analyses_path": hold["b1_launches"],
        "launches_holdout_analyses_path_by_variant": hold["b1_by_variant"],
        "max_abs_err": max(*b1_err_max.values(), pngs["b1_max_err"],
                           hold["b1_max_err"]),
        **b1_entry,
    }, {
        "name": "mbconv_dw",
        "route": "cuda",
        "source": "wsunet_tpu_torch/csrc/mbconv_dw.cu",
        "replaces": None,
        "max_abs_err": b3_out["max_err_y"],
        **b3_out["total"],
    }, {
        "name": "gdfn_gate",
        "route": "cuda",
        "source": "wsunet_tpu_torch/csrc/gdfn_gate.cu",
        "replaces": None,
        "max_abs_err": b4_out["max_err"],
        "launches_a_forward": b4_out["forward_launches"],
        **b4_out["total"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--b3"]:
        sys.exit(b3_only())
    if sys.argv[1:2] == ["--b4"]:
        sys.exit(b4_only())
    if sys.argv[1:2] == ["--cli-checked"]:
        sys.exit(cli_checked(pathlib.Path(sys.argv[2]), sys.argv[3:]))
    if sys.argv[1:2] == ["--holdout-checked"]:
        sys.exit(holdout_checked(pathlib.Path(sys.argv[2]), sys.argv[3:]))
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                               pathlib.Path(sys.argv[4])))
    sys.exit(main())
