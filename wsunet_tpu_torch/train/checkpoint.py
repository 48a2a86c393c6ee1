"""Reading a trained run (port of the reading half of
``wsunet_tpu/train/checkpoint.py``).

A run is ``<model_dir>/<method>/<run>/config.json`` plus ``best.npz``: the
f32 parameters of the run's best checkpoint, flattened with '/'-joined
Flax paths as keys, and for a model with batch norm (B0) its running
statistics under keys that start with ``batch_stats/``
(``scripts/export_torch_weights.py`` writes it from the Orbax store
``model/best``, which only JAX can read).  Both are read with json and
numpy alone.
"""

import json
import pathlib

import numpy as np

PARAMS_FILE = "best.npz"
STATS_PREFIX = "batch_stats/"


def load_config(experiment_dir: pathlib.Path) -> dict:
    with open(pathlib.Path(experiment_dir) / "config.json") as f:
        return json.load(f)


def load_params(experiment_dir: pathlib.Path) -> tuple:
    """``best.npz`` unflattened into two nested dicts of numpy arrays,
    (params, batch_stats), as ``models.convert`` takes them;
    ``batch_stats`` is empty for a model without batch norm."""
    path = pathlib.Path(experiment_dir) / PARAMS_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"no {PARAMS_FILE} at {path.parent} (export it from the Orbax "
            "checkpoint with scripts/export_torch_weights.py)")
    params, stats = {}, {}
    with np.load(path, allow_pickle=False) as npz:
        for key in npz.files:
            tree, path = params, key
            if key.startswith(STATS_PREFIX):
                tree, path = stats, key[len(STATS_PREFIX):]
            *parents, leaf = path.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    return params, stats
