"""Run directories: reading and writing (port of
``wsunet_tpu/train/checkpoint.py``).

A run is ``<model_dir>/<method>/<run>/`` with

- ``config.json``: the run's full config (``save_config``);
- ``best.npz``: the f32 parameters of the best checkpoint, flattened with
  '/'-joined Flax paths as keys, and for a model with batch norm (B0) its
  running statistics under keys that start with ``batch_stats/``.  The
  eval path reads it with numpy alone (``load_params``).  The JAX
  package's runs get theirs from ``scripts/export_torch_weights.py``; a
  run the port trains writes it at every save of ``model/best``
  (``save_params``);
- ``model/latest`` and ``model/best`` (runs the port trained): each a
  directory holding ``state.pt``, the ``torch.save`` of a dict of the
  model's ``state_dict``, the optimizer's and the scheduler's state,
  ``epoch``, ``best_val_loss`` and ``patience``.  Every save goes to a
  temporary sibling first and is renamed into place (``_replace_dir``), so
  a crash mid-save leaves the previous checkpoint readable.
"""

import json
import os
import pathlib
import shutil
import typing

import numpy as np
import torch

PARAMS_FILE = "best.npz"
STATS_PREFIX = "batch_stats/"
STATE_FILE = "state.pt"


def save_config(experiment_dir: pathlib.Path, config: dict):
    experiment_dir = pathlib.Path(experiment_dir)
    experiment_dir.mkdir(parents=True, exist_ok=True)
    with open(experiment_dir / "config.json", "w") as f:
        json.dump(config, f, indent=4, sort_keys=True, default=str)


def load_config(experiment_dir: pathlib.Path) -> dict:
    with open(pathlib.Path(experiment_dir) / "config.json") as f:
        return json.load(f)


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> {'/'-joined path: array}, keys sorted."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        value = tree[key]
        if isinstance(value, dict):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def save_params(experiment_dir: pathlib.Path, params: dict) -> pathlib.Path:
    """Write ``best.npz`` from a Flax-layout params tree, through a
    temporary file renamed into place."""
    arrays = flatten_tree(params)
    path = pathlib.Path(experiment_dir) / PARAMS_FILE
    tmp = path.with_name(PARAMS_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


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


def _replace_dir(src: pathlib.Path, dst: pathlib.Path):
    """Swap ``dst`` for ``src`` by renames, never leaving a moment with no
    usable checkpoint on disk: ``dst`` is renamed to ``<dst>.old`` first
    and removed only after ``src`` took its place (``load_checkpoint``
    falls back to ``.old`` after a crash between the two renames)."""
    old = dst.with_name(dst.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if dst.exists():
        dst.rename(old)
    src.rename(dst)
    if old.exists():
        shutil.rmtree(old)


def save_checkpoint(
    experiment_dir: pathlib.Path,
    state: typing.Any,
    is_best: bool = False,
):
    """Write ``model/latest``; copy it to ``model/best`` when
    ``is_best``.  Both go to a temporary sibling first and are renamed
    into place, so an interrupted save leaves the previous checkpoint
    intact."""
    model_dir = pathlib.Path(experiment_dir) / "model"
    model_dir.mkdir(parents=True, exist_ok=True)
    latest = (model_dir / "latest").resolve()
    tmp = (model_dir / "latest.tmp").resolve()
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    torch.save(state, tmp / STATE_FILE)
    _replace_dir(tmp, latest)
    if is_best:
        best = (model_dir / "best").resolve()
        best_tmp = (model_dir / "best.tmp").resolve()
        if best_tmp.exists():
            shutil.rmtree(best_tmp)
        shutil.copytree(latest, best_tmp)
        _replace_dir(best_tmp, best)


def load_checkpoint(experiment_dir: pathlib.Path,
                    which: str = "best") -> dict:
    """The state dict saved in ``model/<which>``, its tensors on the CPU
    (``model/<which>.old`` when a crash fell between the two renames of
    ``_replace_dir``)."""
    path = (pathlib.Path(experiment_dir) / "model" / which).resolve()
    if not path.exists():
        old = path.with_name(path.name + ".old")
        if not old.exists():
            raise FileNotFoundError(f"no checkpoint at {path}")
        path = old
    return torch.load(path / STATE_FILE, map_location="cpu",
                      weights_only=True)
