"""Dataset catalog (port of ``wsunet_tpu/data/catalog.py``).

The catalog is data only: pandas DataFrames of ``files.csv`` rows, with
the JAX package's predicates, columns, sort order and shuffle.  pandas is
imported inside the functions (the card's machine has none).

``resolve_path`` matches path components case-insensitively: files.csv
rows say ``stego_LSBR_...`` while the directories are ``stego_LSBr_...``.
"""

import glob
import pathlib
import typing


def resolve_path(root: pathlib.Path, name: str) -> pathlib.Path:
    """``root/name``, matching components case-insensitively.  A truly
    missing component resolves to the literal join, so that the batched
    decode treats it as a failed read of that image."""
    path = pathlib.Path(root) / name
    if path.exists():
        return path
    cur = pathlib.Path(root)
    for part in pathlib.Path(name).parts:
        nxt = cur / part
        if not nxt.exists() and cur.is_dir():
            matches = [p for p in cur.iterdir()
                       if p.name.lower() == part.lower()]
            if len(matches) == 1:
                nxt = matches[0]
        cur = nxt
    return cur


def collect_files(dataset: pathlib.Path, patterns: typing.Sequence[str],
                  split: str = None, ignore_missing: bool = False):
    """files.csv rows under ``dataset`` for the glob patterns, or the rows
    of a split CSV."""
    import pandas as pd

    dataset = pathlib.Path(dataset)
    if split is not None:
        return pd.read_csv(dataset / split, dtype={"device": str})
    frames = []
    for pattern in patterns:
        for path in glob.glob(str(dataset / pattern)):
            try:
                frames.append(pd.read_csv(pathlib.Path(path) / "files.csv"))
            except Exception:
                if not ignore_missing:
                    raise
    if not frames:
        raise FileNotFoundError(
            f"no files.csv found under {dataset} for patterns {patterns}")
    return pd.concat(frames)


def order_rows(df, shuffle_seed: int = None, skip_num_images: int = None,
               take_num_images: int = None):
    """Sort by name, then an optional shuffle (seed 0 is a seed), skip and
    take."""
    df = df.sort_values("name").reset_index(drop=True)
    if shuffle_seed is not None:
        df = df.sample(frac=1.0, random_state=shuffle_seed)
    if skip_num_images is not None:
        df = df[skip_num_images:]
    if take_num_images is not None:
        df = df[:take_num_images]
    return df


def _filter_demosaic(df, demosaic):
    if demosaic is None:
        return df
    if isinstance(demosaic, str):
        return df[df["demosaic"] == demosaic]
    return df[df["demosaic"].isin(demosaic)]


def precovers(dataset: pathlib.Path, demosaic=None, split: str = None,
              ignore_missing: bool = False, **order_kw):
    """Uncompressed cover images."""
    df = collect_files(dataset, ["images*"], split=split,
                       ignore_missing=ignore_missing)
    df = _filter_demosaic(df, demosaic)
    if "stego_method" in df:
        df = df[df["stego_method"].isna()]
    if "quality" in df:
        df = df[df["quality"].isna()]
    return order_rows(df, **order_kw)


def covers(dataset: pathlib.Path, quality: int = None,
           samp_factor: str = None, split: str = None,
           ignore_missing: bool = False, **order_kw):
    """JPEG cover images."""
    df = collect_files(dataset, ["jpegs*"], split=split,
                       ignore_missing=ignore_missing)
    if quality is not None:
        df = df[df["quality"] == f"q{quality}"]
    if samp_factor is not None:
        df = df[df["samp_factor"] == samp_factor]
    return order_rows(df, **order_kw)


def _filter_stego(df, stego_method, alpha, color_strategy, simulator):
    if stego_method is not None:
        df = df[df["stego_method"] == stego_method]
    if alpha is not None:
        df = df[df["alpha"] == alpha]
    if color_strategy is not None:
        df = df[df["color_strategy"] == color_strategy]
    if simulator is not None:
        df = df[df["simulator"] == simulator]
    return df


def stego_spatial(dataset: pathlib.Path, stego_method: str = None,
                  alpha: float = None, color_strategy: str = None,
                  simulator: str = None, demosaic=None, split: str = None,
                  ignore_missing: bool = False, **order_kw):
    """Spatial-domain stego images (``alpha`` compared as the float read
    from the CSV)."""
    df = collect_files(dataset, ["stego*"], split=split,
                       ignore_missing=ignore_missing)
    df = _filter_demosaic(df, demosaic)
    df = _filter_stego(df, stego_method, alpha, color_strategy, simulator)
    if "quality" in df:
        df = df[df["quality"].isna()]
    return order_rows(df, **order_kw)


def cover_stego_pairs(dataset: pathlib.Path, stego_method: str = None,
                      alpha: float = None, color_strategy: str = None,
                      simulator: str = None, demosaic=None,
                      split: str = None, ignore_missing: bool = False,
                      **order_kw):
    """Cover-stego pairs joined by filename stem, sorted by the cover's
    stem."""
    df = collect_files(dataset, ["images*", "stego*"], split=split,
                       ignore_missing=ignore_missing)
    df = _filter_demosaic(df, demosaic)
    if "quality" in df:
        df = df[df["quality"].isna()]

    df_c = df[df["stego_method"].isna()].copy()
    df_s = _filter_stego(df[~df["stego_method"].isna()].copy(),
                         stego_method, alpha, color_strategy, simulator)

    df_c["stem"] = df_c["name"].apply(lambda f: pathlib.Path(f).stem)
    df_s["stem"] = df_s["name"].apply(lambda f: pathlib.Path(f).stem)
    df = df_c.merge(df_s, how="left", on=["stem"], suffixes=("_c", "_s"))
    df["name"] = df["name_c"]
    df = order_rows(df.drop("stem", axis=1), **order_kw)
    df["stem"] = df["name_c"].apply(lambda f: pathlib.Path(f).stem)
    return df.sort_values(["stem", "name_c"]).drop("stem", axis=1)
