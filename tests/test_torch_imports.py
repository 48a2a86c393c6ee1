"""The port's import rule: no module of wsunet_tpu_torch, and not
chip_smoke.py, imports JAX, the JAX package or scikit-learn anywhere, and
none imports pandas, PIL, matplotlib, seaborn, cv2 or scipy when it is
imported
(the card's machine has none of them; the CSV and plotting edges import
them inside their functions).

Each module is imported in a fresh interpreter in which those packages
cannot be imported at all; and every import statement of the sources is
read, function bodies included.  The detection path (``simulate``,
``ws-eval``, ``roc --b0``) runs in such an interpreter, and loads none of
pandas, PIL, cv2, matplotlib or seaborn; so do ``init_dataset``,
``bootstrap_roc_cis``, ``holdout_roc``, ``run_correlation`` and
``bucket_quantiles``, called on a tiny catalog."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "wsunet_tpu_torch"
BLOCKED = ["jax", "jaxlib", "flax", "optax", "orbax", "wsunet_tpu", "sklearn",
           "pandas", "PIL", "matplotlib", "seaborn", "cv2", "scipy"]
NEVER = {"jax", "jaxlib", "flax", "optax", "orbax", "wsunet_tpu", "sklearn"}


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods + ["chip_smoke"]


MODULES = _modules()

_PROBE = r"""
import importlib, importlib.abc, json, sys
BLOCKED = set(json.loads(sys.argv[1]))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
out = {}
for mod in json.loads(sys.argv[2]):
    try:
        importlib.import_module(mod)
        out[mod] = "ok"
    except BaseException as e:
        out[mod] = f"{type(e).__name__}: {e}"
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(BLOCKED),
         json.dumps(MODULES)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_the_blocked_packages(imported, module):
    assert imported[module] == "ok"
    assert imported["loaded"] == []


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_sklearn_anywhere(path):
    bad = [n for n in _imported_names(path) if n.split(".")[0] in NEVER]
    assert bad == []


def test_the_training_modules_are_covered():
    """The trainer's modules are among those imported and read above."""
    for mod in ("wsunet_tpu_torch.train.train_unet",
                "wsunet_tpu_torch.train.losses",
                "wsunet_tpu_torch.train.config",
                "wsunet_tpu_torch.train.checkpoint",
                "wsunet_tpu_torch.data.simulate",
                "wsunet_tpu_torch.utils.seeding",
                "wsunet_tpu_torch.utils.run_names",
                "wsunet_tpu_torch.utils.logging"):
        assert mod in MODULES


def test_the_b0_training_and_filters_modules_are_covered():
    """The B0 trainer's and filters-eval's modules are among those
    imported and read above."""
    for mod in ("wsunet_tpu_torch.train.train_b0",
                "wsunet_tpu_torch.train.bn_recalibrate",
                "wsunet_tpu_torch.ws.filters_eval",
                "wsunet_tpu_torch.models.b0",
                "wsunet_tpu_torch.models.convert",
                "wsunet_tpu_torch.ops.filters"):
        assert mod in MODULES


def test_the_analyses_and_cli_edge_modules_are_covered():
    """The analyses', init-dataset's and the hooks' modules are among
    those imported and read above."""
    for mod in ("wsunet_tpu_torch.analyses",
                "wsunet_tpu_torch.analyses.correlation",
                "wsunet_tpu_torch.analyses.error_boxes",
                "wsunet_tpu_torch.analyses.contour",
                "wsunet_tpu_torch.analyses.saliency",
                "wsunet_tpu_torch.utils.aggregates",
                "wsunet_tpu_torch.utils.profiling",
                "wsunet_tpu_torch.data.init_dataset",
                "wsunet_tpu_torch.serve",
                "wsunet_tpu_torch.cli"):
        assert mod in MODULES


_PATH_PROBE = r"""
import importlib.abc, json, pathlib, shutil, sys
BLOCKED = set(json.loads(sys.argv[1]))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
from wsunet_tpu_torch.cli import main
src, root, res = (pathlib.Path(a) for a in sys.argv[2:5])
(root / "images").mkdir(parents=True)
lines = ["name,height,width"]
for p in sorted(src.glob("*.png"))[:6]:
    shutil.copyfile(p, root / "images" / p.name)
    lines.append(f"images/{p.name},128,128")
(root / "images" / "files.csv").write_text("\n".join(lines) + "\n")
common = ["--data", str(root), "--results", str(res), "--device", "cpu"]
main(["simulate", "--data", str(root), "--device", "cpu", "--alphas", "0.1"])
main(["ws-eval", *common, "--models", "KB", "KB-w", "--alphas", "0.1"])
main(["roc", *common, "--alphas", "0.1", "--models", "KB", "UNet", "--b0"])
print(json.dumps({
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED),
    "port": sorted(m for m in sys.modules
                   if m.startswith("wsunet_tpu_torch."))}))
"""

# the detection path's modules, which must load without the host packages
DETECTION_PATH = ("wsunet_tpu_torch.io.png", "wsunet_tpu_torch.io.imread",
                  "wsunet_tpu_torch.utils.table",
                  "wsunet_tpu_torch.data.catalog",
                  "wsunet_tpu_torch.data.pipeline",
                  "wsunet_tpu_torch.data.simulate",
                  "wsunet_tpu_torch.ws.estimate",
                  "wsunet_tpu_torch.ws.unet_eval",
                  "wsunet_tpu_torch.ws.filters_eval",
                  "wsunet_tpu_torch.detect.b0_eval",
                  "wsunet_tpu_torch.detect.roc", "wsunet_tpu_torch.cli")


def test_the_detection_path_runs_without_the_host_packages(tmp_path):
    """``simulate``, ``ws-eval`` and ``roc --b0`` run in an interpreter
    where pandas, PIL, cv2, matplotlib and seaborn cannot be imported:
    the path's modules load and none of those packages does."""
    host = ["pandas", "PIL", "cv2", "matplotlib", "seaborn"]
    proc = subprocess.run(
        [sys.executable, "-c", _PATH_PROBE, json.dumps(host),
         str(REPO / "data_ablation" / "p128" / "images"),
         str(tmp_path / "cat"), str(tmp_path / "res")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    for mod in DETECTION_PATH:
        assert mod in out["port"], mod
    assert "roc_0.1.png not drawn" in proc.stderr
    for name in ("estimation/ws_sweep_LSBR.csv", "detection/auc_0.1.csv",
                 "detection/roc_0.1.csv"):
        assert (tmp_path / "res" / name).stat().st_size > 0


_CALL_PROBE = r"""
import importlib.abc, json, pathlib, shutil, sys
BLOCKED = set(json.loads(sys.argv[1]))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import numpy as np
from wsunet_tpu_torch.analyses import bucket_quantiles, run_correlation
from wsunet_tpu_torch.cli import main
from wsunet_tpu_torch.data.init_dataset import init_dataset
from wsunet_tpu_torch.detect import Fold, bootstrap_roc_cis, holdout_roc
from wsunet_tpu_torch.utils.table import Table, concat, read_csv
src, root, res = (pathlib.Path(a) for a in sys.argv[2:5])
(root / "images").mkdir(parents=True)
for p in sorted(src.glob("*.png"))[:4]:
    shutil.copyfile(p, root / "images" / p.name)
cat = init_dataset(root, split_fractions=(0.5, 0.5, 0.0))
main(["simulate", "--data", str(root), "--device", "cpu", "--alphas",
      "0.1", "1.0"])
stego = read_csv(root / "stego_LSBr_alpha_0.1_independent_images" /
                 "files.csv")
concat([cat, stego]).to_csv(root / "eval.csv")
out = {"init_dataset": len(cat)}
out["holdout_roc"] = len(holdout_roc(
    root, [Fold(eval_split="eval.csv")], results_dir=res,
    filter_models=("KB",), stego_methods=("LSBR",), alphas=(0.1,),
    device="cpu"))
scores = read_csv(res / "detection" / "scores_holdout.csv")
out["bootstrap_roc_cis"] = len(bootstrap_roc_cis(scores, n_boot=50))
rows, agg = run_correlation(root, filter_names=("KB", "AVG"),
                            unet_methods=(), device="cpu")
out["run_correlation"] = [len(rows), agg.columns]
rng = np.random.default_rng(0)
out["bucket_quantiles"] = len(bucket_quantiles(
    {"KB": rng.integers(0, 20, 500) / 2.0, "AVG": rng.random(500)}, "KB"))
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


def test_the_tables_and_analyses_are_called_without_the_host_packages(
        tmp_path):
    """``init_dataset``, ``bootstrap_roc_cis``, ``holdout_roc``,
    ``run_correlation`` and ``bucket_quantiles`` are called, not only
    imported, in an interpreter where pandas, PIL, cv2, matplotlib and
    seaborn cannot be imported, and none of those packages loads."""
    host = ["pandas", "PIL", "cv2", "matplotlib", "seaborn"]
    proc = subprocess.run(
        [sys.executable, "-c", _CALL_PROBE, json.dumps(host),
         str(REPO / "data_ablation" / "p128" / "images"),
         str(tmp_path / "cat"), str(tmp_path / "res")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"init_dataset": 4, "holdout_roc": 1,
                   "bootstrap_roc_cis": 1,
                   "run_correlation": [8, ["", "KB", "AVG"]],
                   "bucket_quantiles": 10, "loaded": []}
    for name in ("auc_0.1_holdout.csv", "auc_0.1_holdout_ci.csv",
                 "roc_0.1_holdout.csv", "auc_by_alpha_holdout.csv"):
        assert (tmp_path / "res" / "detection" / name).stat().st_size > 0
