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
    the JAX package's function returns for them (a RangeIndex; a column
    of str or NaN in every row in pandas' text dtype, as read_csv and its
    row selections give it; None stays an object); a DataFrame as it is.
    A table has no index, so compare with the JAX frame's rows after
    ``reset_index(drop=True)``."""
    import math

    import pandas as pd

    from wsunet_tpu_torch.utils.table import Table

    if not isinstance(rows, Table):
        return rows
    cols = {name: rows[name] for name in rows.columns}
    df = pd.DataFrame(cols, index=pd.RangeIndex(len(rows)))
    for name, col in cols.items():
        if col.dtype == object and all(
                isinstance(x, str) or (isinstance(x, float) and
                                       math.isnan(x)) for x in col):
            df[name] = df[name].astype("str")
    return df


# what the card's machine lacks, and the detection path must not import
HOST_PACKAGES = ("pandas", "PIL", "cv2", "matplotlib", "seaborn")


def run_without_host_packages(args, tmp_path: pathlib.Path,
                              timeout: int = 600, code: str = None,
                              check: bool = True):
    """``python -m wsunet_tpu_torch *args`` (or, with ``code``, ``python
    -c code *args``) in a fresh interpreter where pandas, PIL, cv2,
    matplotlib and seaborn cannot be imported: a stub package of each
    name, first on ``PYTHONPATH``, raises ImportError.  Fails the test on
    a non-zero exit unless ``check`` is false; returns the finished
    process."""
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
    head = ["-c", code] if code is not None else ["-m", "wsunet_tpu_torch"]
    proc = subprocess.run(
        [sys.executable, *head, *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    if check:
        assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def save_columns(df, path: pathlib.Path) -> None:
    """A DataFrame's columns as numpy arrays in an ``.npz`` file (text as
    object arrays), for ``load_table`` in a process without pandas."""
    import numpy as np

    np.savez(path, __columns__=np.array(list(df.columns), dtype=object),
             **{f"c{i}": np.asarray(df[c]) for i, c in enumerate(df.columns)})


# ``load_table(path)``: the table ``save_columns`` wrote, the same values
# and dtypes; pasted into the code of ``run_without_host_packages``
LOAD_TABLE = """
def load_table(path):
    import numpy as np
    from wsunet_tpu_torch.utils.table import Table
    z = np.load(path, allow_pickle=True)
    names = list(z["__columns__"])
    return Table({n: z[f"c{i}"] for i, n in enumerate(names)},
                 n=len(z["c0"]) if names else 0)
"""
