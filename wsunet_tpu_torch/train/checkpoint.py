"""Reading a trained run (port of the reading half of
``wsunet_tpu/train/checkpoint.py``).

A run is ``<model_dir>/<method>/<run>/config.json`` plus ``best.npz``: the
f32 parameters of the run's best checkpoint, flattened with '/'-joined
Flax paths as keys (``scripts/export_torch_weights.py`` writes it from the
Orbax store ``model/best``, which only JAX can read).  Both are read with
json and numpy alone.
"""

import json
import pathlib

import numpy as np

PARAMS_FILE = "best.npz"


def load_config(experiment_dir: pathlib.Path) -> dict:
    with open(pathlib.Path(experiment_dir) / "config.json") as f:
        return json.load(f)


def load_params(experiment_dir: pathlib.Path) -> dict:
    """``best.npz`` unflattened into the nested dict of numpy arrays that
    ``models.convert.unet_state_dict_from_flax`` takes."""
    path = pathlib.Path(experiment_dir) / PARAMS_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"no {PARAMS_FILE} at {path.parent} (export it from the Orbax "
            "checkpoint with scripts/export_torch_weights.py)")
    tree = {}
    with np.load(path, allow_pickle=False) as npz:
        for key in npz.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    return tree
