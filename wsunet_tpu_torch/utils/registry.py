"""Model registry over run directories (port of
``wsunet_tpu/utils/registry.py``).

``<model_dir>/<stego_method>/<run_name>/config.json`` beside the run's
``best.npz`` (where the JAX package looks for ``model/best``).  pandas is
imported inside the functions.
"""

import glob
import json
import pathlib
import typing

from ..train.checkpoint import PARAMS_FILE
from .errors import UserError


def scan_models(model_dir: pathlib.Path, stego_method: str):
    """Config rows (a DataFrame) of the runs that have a ``best.npz``."""
    import pandas as pd

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
    return pd.DataFrame(rows)


def get_model_name(model_dir: pathlib.Path, stego_method: str,
                   **filters: typing.Any) -> str:
    """The one run name matching the filters; ``UserError`` when none or
    several match."""
    df = scan_models(model_dir, stego_method)
    if len(df):
        df = df[df.stego_method == stego_method]
        for key, value in filters.items():
            if value is None:
                df = df[df[key].isna()]
            else:
                df = df[df[key] == value]
    if len(df) < 1:
        raise UserError(f"no model for {stego_method=} {filters} found")
    if len(df) > 1:
        raise UserError(f"multiple models for {stego_method=} {filters} found")
    return df["model_name"].iloc[0]
