"""What the benchmark's files import: nothing of the JAX side anywhere,
and nothing of the program in the references (CPU, in fresh processes)."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "port_bench"

IMPORT_ALL = r"""
import pathlib, sys
sys.path.insert(0, {root!r})
from port_bench.harness import cells
for path in sorted(pathlib.Path({bench!r}).rglob("*.py")):
    if "tests" not in path.parts:
        cells.load_module(path)
import wsunet_tpu_torch, wsunet_tpu_torch.cli
from port_bench import run
print(",".join(run.forbidden_modules()))
"""

IMPORT_REFERENCE = r"""
import sys
sys.path.insert(0, {root!r})
import port_bench.reference.unet, port_bench.reference.b0
import port_bench.reference.train
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("wsunet_tpu_torch", "wsunet_tpu",
                                             "jax", "jaxlib", "flax"))))
"""


def _run(code: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           bench=str(BENCH_DIR))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def test_no_module_of_the_jax_side_is_loaded():
    assert _run(IMPORT_ALL) == ""


def test_references_import_nothing_of_the_program():
    assert _run(IMPORT_REFERENCE) == ""
