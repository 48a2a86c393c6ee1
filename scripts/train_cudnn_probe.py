#!/usr/bin/env python3
"""Time the U-Net trainer's f32 recipes under cuDNN's heuristic choice of
conv algorithm and under its autotuner, on one NVIDIA card.

    python3 scripts/train_cudnn_probe.py     # from the root of the repository

The trainer leaves ``torch.backends.cudnn.benchmark`` off.  This script
trains seeded ``unet_2`` in the two f32 recipes of ``chip_smoke.py`` phase
11 (b) (``RECIPES``: LSBR at crop 512, B=4; dropout at crop 320, B=12),
first with the autotuner off and then on, through ``chip_smoke.time_recipe``
(step ms by CUDA events, img/s by host clock, peak memory, busy share, top
kernels).  Then it times alone the conv that holds the dropout recipe's
step, d2.conv1's forward, f32 [12, 256, 162, 162] x [128, 256, 3, 3] (the
reflect-padded 160x160 activation), by CUDA events: NCHW with the autotuner
off and on, and channels-last; beside it the same conv with 128 input
channels (d2.conv2's shape).  It prints the card's name and power limit,
one JSON line per row, and checks nothing about the port (``chip_smoke.py``
does).  It needs a card and imports no JAX.
"""

import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import RECIPES, cuda_ms, time_recipe  # noqa: E402

CONVS = {"d2.conv1 (256 -> 128)": (256, 128),
         "d2.conv2 (128 -> 128)": (128, 128)}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_cudnn_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for label in ("LSBR f32", "dropout f32"):
            time_recipe(label, RECIPES[label], card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (cin, cout) in CONVS.items():
        x = torch.randn(12, cin, 162, 162, device=dev, generator=g)
        w = torch.randn(cout, cin, 3, 3, device=dev, generator=g) / (
            3 * cin ** 0.5)
        ms = {}
        for route, xv, bench in (
                ("nchw", x, False), ("nchw_benchmark", x, True),
                ("channels_last", x.contiguous(
                    memory_format=torch.channels_last), False)):
            torch.backends.cudnn.benchmark = bench
            ms[route] = cuda_ms(lambda v: F.conv2d(v, w), [xv], reps=3,
                                iters=3)
        print(f"{name} forward alone, f32 {list(x.shape)} x {list(w.shape)}, "
              f"ms by CUDA events ({card}): " + json.dumps(ms))
    torch.backends.cudnn.benchmark = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
