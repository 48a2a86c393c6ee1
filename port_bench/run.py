"""The benchmark of wsunet_tpu_torch, the PyTorch / CUDA port, on one
NVIDIA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; their files,
the mix's driver, the cell's limits and every metric's reader are found
by name (``harness.cells``).

A run: the inputs and the program's state from the seed, every shape the
window uses warmed up (``setup_s`` runs from the start of this process to
here: imports, the card's first use, kernel builds or loads, weights,
input files, warm-up); then ``--seconds`` of the mix (traced by
torch.profiler with ``--trace 1``); then the peak device memory; then the
program's state freed and the check against the plain reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit
(also the last lines of standard error).

Exits non-zero with no result line when no CUDA card is available or the
cell asks for more than there are, and when a module of the JAX side
(``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``, ``wsunet_tpu``,
compared by whole top-level name) is loaded in this process once the
window has closed.  The program's build and kernel caches are kept under
``build/`` in the checkout, at fixed paths; the run's input files live in
a temporary directory under ``TMPDIR`` and are removed at exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wsunet_tpu")


def _cache_env():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own nvcc builds go to ``build/kernels`` already)."""
    cache = ROOT / "build" / "port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules of the JAX side, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    sys.path.insert(0, str(ROOT))

    from port_bench.harness import cells
    bench = cells.benchmark(ROOT)
    w = cells.workload(bench, args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < w["chips"]:
        print(f"needs {w['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    result = run(bench, args, torch.device("cuda", 0))
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def run(bench: dict, args, device, overrides: dict = None,
        variant: str = None):
    """One run of a cell; the result line's object, or None (with the
    reason on standard error) when a JAX module is loaded.  ``overrides``
    (small traffic parameters) serve the CPU tests; ``variant`` names one
    of the driver's ``CONTROLS``, a cell with the plain reference, or a
    fault, in the program's place, which ``control.py`` and the tests run
    to see the check fail."""
    import torch
    from port_bench.harness import cells, trace

    spans = trace.Spans(bool(args.trace))
    e2e, layer = cells.metrics_of(bench, args.workload)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as data:
        ctx = cells.context(ROOT, bench, args.workload, args.seed, device,
                            data, spans, overrides)
        drv = cells.driver(ctx.traffic["kind"])
        cell = (drv.Cell if variant is None else drv.CONTROLS[variant])(ctx)
        cell.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        tr = None
        if args.trace:
            with trace.Trace() as tr:
                cell.window(args.seconds)
        else:
            cell.window(args.seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        run_info = _RunInfo(ctx, tr, device)
        metrics = {}
        if args.trace:
            for m in layer:
                value = cells.reader(m["name"])(run_info)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in e2e:
                value = (setup_s if m["name"] == "setup_s"
                         else cells.reader(m["name"])(run_info))
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for line in cell.evidence():
            print(line)
        cell.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        readings = cell.check()
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of the JAX side are loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return None
    checks = {k: {"value": v, "limit": ctx.limits[k]}
              for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and ctx.counts["failed"] == 0
    out = {"correct": correct, "attempted": ctx.counts["attempted"],
           "failed": ctx.counts["failed"], "metrics": metrics,
           "device": _device(device, peak, tr)}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


class _RunInfo:
    """What a metric reader sees: the cell's files and counts, the trace
    (None in an untraced run), the card's name and peaks."""

    def __init__(self, ctx, tr, device):
        from port_bench.harness import flops
        import torch

        self.config, self.traffic, self.counts = (ctx.config, ctx.traffic,
                                                  ctx.counts)
        self.trace = tr
        self.device_name = (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")
        self.peaks = flops.peaks(self.device_name)


def _device(device, peak: int, tr) -> dict:
    import torch

    if device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "count": 1, "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0}
    if tr is not None:
        d["busy_s"] = tr.busy_s
        d["window_s"] = tr.window_s
    return d


if __name__ == "__main__":
    sys.exit(main())
