"""A small catalog for the port's parity tests: the first ``n`` covers of
``data_ablation/p128`` (128x128 grayscale PNGs) with their ``files.csv``,
and LSBr stego made by the JAX package's own ``simulate`` command, whose
``files.csv`` rows say ``stego_LSBR_...`` while the directories are
``stego_LSBr_...``."""

import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[1]
P128 = REPO / "data_ablation" / "p128"


def make_catalog(root: pathlib.Path, n: int = 12,
                 alphas=(0.1, 0.01)) -> pathlib.Path:
    from wsunet_tpu.cli import main as jax_main

    root = pathlib.Path(root)
    (root / "images").mkdir(parents=True)
    names = sorted(p.name for p in (P128 / "images").glob("*.png"))[:n]
    lines = ["name,height,width"]
    for name in names:
        shutil.copyfile(P128 / "images" / name, root / "images" / name)
        lines.append(f"images/{name},128,128")
    (root / "images" / "files.csv").write_text("\n".join(lines) + "\n")
    jax_main(["simulate", "--data", str(root), "--method", "LSBr",
              "--alphas", *map(str, alphas)])
    return root


def frame(rows):
    """The port's rows (a ``utils.table.Table``) as the pandas DataFrame
    the JAX package's function returns for them; a DataFrame as it is.
    A table has no index, so compare with the JAX frame's rows after
    ``reset_index(drop=True)``."""
    from wsunet_tpu_torch.utils.table import Table

    return rows.to_pandas() if isinstance(rows, Table) else rows


# what the card's machine lacks, and the detection path must not import
HOST_PACKAGES = ("pandas", "PIL", "cv2", "matplotlib", "seaborn")


def run_without_host_packages(args, tmp_path: pathlib.Path,
                              timeout: int = 600):
    """``python -m wsunet_tpu_torch *args`` in a fresh interpreter where
    pandas, PIL, cv2, matplotlib and seaborn cannot be imported: a stub
    package of each name, first on ``PYTHONPATH``, raises ImportError.
    Fails the test on a non-zero exit; returns the finished process."""
    import os
    import subprocess
    import sys

    stubs = pathlib.Path(tmp_path) / "no_host_packages"
    for name in HOST_PACKAGES:
        (stubs / name).mkdir(parents=True, exist_ok=True)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed here')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(stubs), str(REPO)]))
    proc = subprocess.run(
        [sys.executable, "-m", "wsunet_tpu_torch", *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc
