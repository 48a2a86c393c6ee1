"""Dataset catalog (port of ``wsunet_tpu/data/catalog.py``).

The catalog is data only: tables (``utils.table.Table``) of ``files.csv``
rows, with the JAX package's predicates, columns, sort order and shuffle;
they hold what the JAX package's DataFrames hold, without pandas.

``resolve_path`` matches path components case-insensitively: files.csv
rows say ``stego_LSBR_...`` while the directories are ``stego_LSBr_...``.
"""

import glob
import pathlib
import typing

import numpy as np

from ..utils.table import Table, concat, isna, read_csv, take


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
                  split: str = None, ignore_missing: bool = False) -> Table:
    """files.csv rows under ``dataset`` for the glob patterns, or the rows
    of a split CSV."""
    dataset = pathlib.Path(dataset)
    if split is not None:
        return read_csv(dataset / split, dtype={"device": str})
    tables = []
    for pattern in patterns:
        for path in glob.glob(str(dataset / pattern)):
            try:
                tables.append(read_csv(pathlib.Path(path) / "files.csv"))
            except Exception:
                if not ignore_missing:
                    raise
    if not tables:
        raise FileNotFoundError(
            f"no files.csv found under {dataset} for patterns {patterns}")
    return concat(tables)


def order_rows(df: Table, shuffle_seed: int = None,
               skip_num_images: int = None,
               take_num_images: int = None) -> Table:
    """Sort by name, then an optional shuffle (seed 0 is a seed), skip and
    take."""
    df = df.sort("name")
    if shuffle_seed is not None:
        df = df.shuffle(shuffle_seed)
    if skip_num_images is not None:
        df = df[skip_num_images:]
    if take_num_images is not None:
        df = df[:take_num_images]
    return df


def _filter_demosaic(df: Table, demosaic) -> Table:
    if demosaic is None:
        return df
    if isinstance(demosaic, str):
        return df[df["demosaic"] == demosaic]
    return df[np.isin(df["demosaic"], list(demosaic))]


def precovers(dataset: pathlib.Path, demosaic=None, split: str = None,
              ignore_missing: bool = False, **order_kw) -> Table:
    """Uncompressed cover images."""
    df = collect_files(dataset, ["images*"], split=split,
                       ignore_missing=ignore_missing)
    df = _filter_demosaic(df, demosaic)
    if "stego_method" in df:
        df = df[isna(df["stego_method"])]
    if "quality" in df:
        df = df[isna(df["quality"])]
    return order_rows(df, **order_kw)


def covers(dataset: pathlib.Path, quality: int = None,
           samp_factor: str = None, split: str = None,
           ignore_missing: bool = False, **order_kw) -> Table:
    """JPEG cover images."""
    df = collect_files(dataset, ["jpegs*"], split=split,
                       ignore_missing=ignore_missing)
    if quality is not None:
        df = df[df["quality"] == f"q{quality}"]
    if samp_factor is not None:
        df = df[df["samp_factor"] == samp_factor]
    return order_rows(df, **order_kw)


def _filter_stego(df: Table, stego_method, alpha, color_strategy,
                  simulator) -> Table:
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
                  ignore_missing: bool = False, **order_kw) -> Table:
    """Spatial-domain stego images (``alpha`` compared as the float read
    from the CSV)."""
    df = collect_files(dataset, ["stego*"], split=split,
                       ignore_missing=ignore_missing)
    df = _filter_demosaic(df, demosaic)
    df = _filter_stego(df, stego_method, alpha, color_strategy, simulator)
    if "quality" in df:
        df = df[isna(df["quality"])]
    return order_rows(df, **order_kw)


def _stems(names) -> list:
    return [pathlib.Path(f).stem for f in names]


def _merge_left(left: Table, right: Table, on: str,
                suffixes=("_c", "_s")) -> Table:
    """``left.merge(right, how="left", on=on, suffixes=suffixes)``: each
    left row with each right row of its key, in order (NaN where none);
    columns both sides hold take the suffixes."""
    by_key = {}
    for j, key in enumerate(right[on]):
        by_key.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(left[on]):
        for j in by_key.get(key, [-1]):
            li.append(i)
            ri.append(j)
    li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    both = set(left.columns) & set(right.columns) - {on}
    out = Table(n=len(li))
    for name in left.columns:
        out[name + suffixes[0] if name in both else name] = left[name][li]
    for name in right.columns:
        if name != on:
            out[name + suffixes[1] if name in both else name] = \
                take(right[name], ri)
    return out


def cover_stego_pairs(dataset: pathlib.Path, stego_method: str = None,
                      alpha: float = None, color_strategy: str = None,
                      simulator: str = None, demosaic=None,
                      split: str = None, ignore_missing: bool = False,
                      **order_kw) -> Table:
    """Cover-stego pairs joined by filename stem, sorted by the cover's
    stem."""
    df = collect_files(dataset, ["images*", "stego*"], split=split,
                       ignore_missing=ignore_missing)
    df = _filter_demosaic(df, demosaic)
    if "quality" in df:
        df = df[isna(df["quality"])]

    cover = isna(df["stego_method"])
    df_c = df[cover].copy()
    df_s = _filter_stego(df[~cover].copy(), stego_method, alpha,
                         color_strategy, simulator)

    df_c["stem"] = _stems(df_c["name"])
    df_s["stem"] = _stems(df_s["name"])
    df = _merge_left(df_c, df_s, "stem")
    df["name"] = df["name_c"]
    df = order_rows(df.drop("stem"), **order_kw)
    df["stem"] = _stems(df["name_c"])
    return df.sort(["stem", "name_c"]).drop("stem")
