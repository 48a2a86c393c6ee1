"""Model registry over run directories (port of
``wsunet_tpu/utils/registry.py``).

``<model_dir>/<stego_method>/<run_name>/config.json`` beside the run's
``best.npz`` (where the JAX package looks for ``model/best``).
``get_model_name`` reads the configs with json alone; ``scan_models``
gives them as a table (``utils.table``).
"""

import glob
import json
import pathlib
import typing

from ..train.checkpoint import PARAMS_FILE
from .errors import UserError
from .table import Table, from_rows


def _scan_rows(model_dir: pathlib.Path, stego_method: str) -> list:
    """Config rows (dicts) of the runs that have a ``best.npz``."""
    model_path = pathlib.Path(model_dir) / stego_method
    rows = []
    for cfg_file in map(pathlib.Path,
                        glob.glob(str(model_path / "*" / "config.json"))):
        with open(cfg_file) as f:
            config = json.load(f)
        if config.get("debug", False):
            continue
        if not (cfg_file.parent / PARAMS_FILE).exists():
            continue
        alpha = config.get("alpha")
        if isinstance(alpha, (list, tuple)):  # rate-mixture run
            alpha = "mix" + "-".join(str(a) for a in alpha)
        elif alpha:
            alpha = float(alpha)
        rows.append({
            "model_name": cfg_file.parent.name,
            "stego_method": config.get("stego_method"),
            "alpha": alpha,
            "loss": config.get("loss"),
            "network": config.get("network"),
            "drop_rate": config.get("drop_rate"),
            "lsbr_reference": config.get("lsbr_reference", False),
            "no_stem_stride": config.get("no_stem_stride", False),
        })
    return rows


def scan_models(model_dir: pathlib.Path, stego_method: str) -> Table:
    """Config rows (a table) of the runs that have a ``best.npz``."""
    return from_rows(_scan_rows(model_dir, stego_method))


def get_model_name(model_dir: pathlib.Path, stego_method: str,
                   **filters: typing.Any) -> str:
    """The one run name matching the filters; ``UserError`` when none or
    several match.  A filter of None matches a missing value.  Needs no
    pandas, so the card's machine finds runs by name too."""
    rows = [r for r in _scan_rows(model_dir, stego_method)
            if r["stego_method"] == stego_method]
    for key, value in filters.items():
        if value is None:
            rows = [r for r in rows if r[key] is None]
        else:
            rows = [r for r in rows if r[key] == value]
    if len(rows) < 1:
        raise UserError(f"no model for {stego_method=} {filters} found")
    if len(rows) > 1:
        raise UserError(f"multiple models for {stego_method=} {filters} found")
    return rows[0]["model_name"]
