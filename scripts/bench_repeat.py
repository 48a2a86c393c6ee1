#!/usr/bin/env python3
"""The bench's headline run again and again, the card's clocks beside it.

    python3 scripts/bench_repeat.py [--runs 8] [--out DIR]

Runs ``python -m wsunet_tpu_torch bench --batch-size 128`` (bf16 on B1,
the bench's defaults, as ``chip_smoke.py`` phase 15 runs it) ``--runs``
times, one process after another, while ``nvidia-smi`` samples the card
every 100 ms (SM clock, power, temperature, the clock event reasons,
memory in use) and, every second, the processes holding the card.  For
each run it prints one JSON line: the record's ``value``, ``mfu`` and
``step_ms``, the process's wall seconds and, over the samples taken while
it ran, the SM clock's min and median, the most power drawn, the event
reasons seen (their bits OR-ed), the most memory in use and the most
processes on the card.  Then the lowest ``value`` and ``mfu`` and 0.8 x
each, the rule of ``bench.FLOORS``.  With ``--out`` the raw samples and
the records are written there.  Run from the root of the repository; it
needs a card and imports no JAX.
"""

import argparse
import datetime
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
GPU_FIELDS = ("timestamp,clocks.sm,power.draw,temperature.gpu,"
              "clocks_event_reasons.active,memory.used")


def poll_apps(samples: list, stop: threading.Event) -> None:
    """(time, pids) of the processes on the card, every second."""
    while not stop.is_set():
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
        samples.append((time.time(), out.split()))
        stop.wait(1.0)


def read_gpu(path: pathlib.Path) -> list:
    """(time, SM MHz, W, deg C, reasons, MiB) rows of the sampler's CSV."""
    rows = []
    for line in path.read_text().splitlines():
        f = [v.strip() for v in line.split(",")]
        if len(f) != 6:
            continue
        try:
            t = datetime.datetime.strptime(
                f[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
            rows.append((t, float(f[1]), float(f[2]), float(f[3]),
                         int(f[4], 16), float(f[5])))
        except ValueError:
            continue
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_repeat: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    out_dir = args.out or REPO / "build" / "bench_repeat"
    out_dir.mkdir(parents=True, exist_ok=True)
    gpu_csv = out_dir / "gpu.csv"
    apps, stop = [], threading.Event()
    with open(gpu_csv, "w") as f:
        sampler = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={GPU_FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "100"], stdout=f)
    poller = threading.Thread(target=poll_apps, args=(apps, stop))
    poller.start()
    runs = []
    try:
        for i in range(args.runs):
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "wsunet_tpu_torch", "bench",
                 "--batch-size", "128"], cwd=REPO, capture_output=True,
                text=True, timeout=600)
            t1 = time.time()
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
                return 1
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append((t0, t1, rec))
    finally:
        time.sleep(0.3)
        sampler.terminate()
        sampler.wait()
        stop.set()
        poller.join()
    gpu = read_gpu(gpu_csv)
    records = []
    for i, (t0, t1, rec) in enumerate(runs):
        during = [r for r in gpu if t0 <= r[0] <= t1]
        pids = [p for t, p in apps if t0 <= t <= t1]
        reasons = 0
        for r in during:
            reasons |= r[4]
        row = {"run": i, "value": rec["value"], "mfu": rec.get("mfu"),
               "step_ms": rec.get("step_ms"), "wall_s": t1 - t0,
               "samples": len(during),
               "sm_mhz_min": min((r[1] for r in during), default=None),
               "sm_mhz_median": (float(np.median([r[1] for r in during]))
                                 if during else None),
               "power_w_max": max((r[2] for r in during), default=None),
               "temp_c_max": max((r[3] for r in during), default=None),
               "event_reasons": hex(reasons),
               "memory_mib_max": max((r[5] for r in during), default=None),
               "processes_max": max((len(p) for p in pids), default=None)}
        records.append(rec)
        print(json.dumps(row))
    (out_dir / "records.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records))
    low = min(r["value"] for r in records)
    low_mfu = min(r.get("mfu", 0.0) for r in records)
    print(json.dumps({"runs": len(records), "value_min": low,
                      "value_max": max(r["value"] for r in records),
                      "mfu_min": low_mfu, "floor_value": 0.8 * low,
                      "floor_mfu": 0.8 * low_mfu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
