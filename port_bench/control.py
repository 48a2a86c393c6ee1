"""The controls of each cell's check, read on the card at the cell's own
size.

    python3 port_bench/control.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 2]

For each seed, and for each entry of the cell's driver's ``CONTROLS`` (a
cell with the plain reference, or a planted fault, in the program's
place: for every cell ``control``, the reference in TF32, the precision
below the configurations' float32), it makes a whole run of the cell
(``run.run``) with that variant and prints the numbers the check compares
and whether the run came out correct: one JSON line a seed.  The
benchmark's own runs do not run this; the limits in ``limits/`` were set
from its readings and the program's.
"""

import argparse
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, device, overrides: dict = None,
             seconds: float = 2.0) -> dict:
    """{variant: {"correct": ..., number: reading, ...}} of every control
    of cell ``name`` on ``seed``."""
    from port_bench import run as bench_run
    from port_bench.harness import cells

    bench = cells.benchmark(ROOT)
    w = cells.workload(bench, name)
    traffic = {**cells.load_json(ROOT / "port_bench" / "traffic"
                                 / f"{w['traffic']}.json"),
               **(overrides or {})}
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=seconds,
                                 trace=0)
    out = {}
    for variant in cells.driver(traffic["kind"]).CONTROLS:
        got = bench_run.run(bench, args, device, overrides, variant)
        out[variant] = {"correct": got["correct"],
                        **{k: c["value"] for k, c in got["checks"].items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed,
                                     torch.device("cuda", 0),
                                     seconds=args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
