"""Finding a cell's parts by name, and what a driver is handed.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Each is a file found by its name:

- ``configs/<config>.json``: the model's sizes, dtype and committed run;
- ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming
  the module ``drivers/<kind>.py`` that runs every mix of that kind;
- ``limits/<workload>.json``: the limit of each number the cell's check
  compares;
- ``metrics/<metric>.py``: a reader, ``read(run)``, for each metric.

So a later change adds a configuration, a mix, a cell or a metric as new
files and new entries, and edits none that is there.
"""

import dataclasses
import importlib.util
import json
import pathlib
import threading
import time
import typing

HERE = pathlib.Path(__file__).resolve().parents[1]


def load_json(path: pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def load_module(path: pathlib.Path):
    """A benchmark module by file path (metric files carry dots in their
    names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{path.stem.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: pathlib.Path) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries the cell reports: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    one without it is every cell's that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell]) and m["moves"] in names]
    return e2e, layer


def reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py").read


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py")


@dataclasses.dataclass
class Context:
    """What a driver gets: the checkout's root, the cell's files, the
    seed, the device, a directory for the run's input files, the spans,
    and ``counts``, which the cell fills for the metric readers."""

    root: pathlib.Path
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: typing.Any
    data: pathlib.Path
    spans: typing.Callable
    counts: dict = dataclasses.field(default_factory=dict)


def context(root, bench: dict, name: str, seed: int, device, data,
            spans, overrides: dict = None) -> Context:
    """The context of cell ``name``; ``overrides`` changes traffic
    parameters (the CPU tests' small sizes)."""
    w = workload(bench, name)
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    traffic.update(overrides or {})
    return Context(root=pathlib.Path(root), name=name,
                   config=load_json(HERE / "configs" / f"{w['config']}.json"),
                   traffic=traffic,
                   limits=load_json(HERE / "limits" / f"{name}.json"),
                   seed=seed, device=device, data=pathlib.Path(data),
                   spans=spans)


def counting_reader(read: typing.Callable, stats: dict) -> typing.Callable:
    """``read`` with its calls and seconds counted into ``stats``
    (``decodes``, ``decode_s``); safe under the pipeline's decode threads.
    The pipeline keys its caches by the reader's ``__name__``."""
    lock = threading.Lock()
    stats.update(decodes=0, decode_s=0.0)

    def imread_counted(path):
        t0 = time.perf_counter()
        try:
            return read(path)
        finally:
            dt = time.perf_counter() - t0
            with lock:
                stats["decodes"] += 1
                stats["decode_s"] += dt

    return imread_counted
