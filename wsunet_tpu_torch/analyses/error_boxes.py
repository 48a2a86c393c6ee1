"""Prediction-error boxes bucketed by the KB filter's error (port of
``wsunet_tpu/analyses/error_boxes.py``).

Absolute-residual populations of the KB and AVG filters and the trained
U-Nets over a split, each image subsampled by its filename seed
(``subset_residual``), ordered by the anchor's (KB's) error, split at
``EDGE_VALUES``; per bucket the box statistics (min, q25 - 1.5 IQR, q25,
q50, q75, q75 + 1.5 IQR, max) under the ``ae_boxes_3.csv`` column names.

- ``residual_populations``: the populations over image names, with a
  ``reader=`` and a ``device=`` (``ops.filter_residuals`` and the U-Net
  estimator, in batches).  No pandas.
- ``box_stats``: the statistics without pandas.  pandas' ``quantile`` is
  numpy's linear percentile, so they equal the JAX package's
  ``bucket_quantiles`` bit for bit on the same populations.
- ``bucket_quantiles`` / ``run_error_boxes``: the table
  (``utils.table``, pandas' CSV bytes) and ``ae_boxes_3.csv``, then the
  seaborn figure where matplotlib and seaborn import (otherwise one line
  on stderr says it was not drawn).
"""

import collections
import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..data.pipeline import load_images
from ..io import imread_gray_u8
from ..ops.filters import NAMED_FILTERS, filter_residuals, taps_to_kernel2d
from ..utils.aggregates import iqr_interval, quantile
from ..utils.figures import plotting
from ..utils.seeding import filename_to_image_seed
from ..utils.table import Table, from_rows
from ..ws.unet_eval import get_unet_estimator
from .correlation import unet_runs

EDGE_VALUES = [.5, 1.5, 3.5, 7.5]
UNET_MODELS = (("dropout", "UNet_l1"), ("LSBR", "UNet_l1ws"))
# the columns of ae_boxes_3.csv after Type and edge_interval: the names
# the JAX package's pandas aggregators give them
STATS = ("min", iqr_interval(.25, sign=-1.5).__name__,
         quantile(.25).__name__, quantile(.5).__name__,
         quantile(.75).__name__, iqr_interval(.75, sign=1.5).__name__,
         "max")


def subset_residual(resid: np.ndarray, fname: str, size: int = None):
    """Deterministic per-image pixel subsample (the JAX package's draw:
    numpy's generator seeded by the file name)."""
    if not size:
        return resid.flatten()
    rng = np.random.default_rng(filename_to_image_seed(fname))
    selected = rng.integers(resid.size, size=size)
    selected = (selected // resid.shape[1], selected % resid.shape[1])
    return resid[selected]


def residual_populations(
    root: pathlib.Path,
    names: typing.Sequence[str],
    filter_names: typing.Sequence[str] = ("KB", "AVG"),
    unets: typing.Sequence[typing.Tuple[str, pathlib.Path]] = (),
    num_pixels: int = None,
    batch_size: int = 8,
    fast_conv=False,
    reader: typing.Callable = imread_gray_u8,
    device=None,
) -> "collections.OrderedDict[str, np.ndarray]":
    """{label: absolute residuals of every image, concatenated} for each
    filter, then each ``(label, run directory)`` of ``unets``, on
    ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    pixels = load_images(root, names, reader=reader)
    residuals = [(name, lambda x, k=taps_to_kernel2d(NAMED_FILTERS[name]):
                  filter_residuals(x, k)) for name in filter_names]
    for label, run in unets:
        predict = get_unet_estimator(run.parent, run.name,
                                     fast_conv=fast_conv, device=dev)
        residuals.append((label, lambda x, p=predict:
                          x[:, 1:-1, 1:-1] - p(x)))
    results = collections.OrderedDict()
    for label, residual in residuals:
        parts = []
        for start in range(0, len(pixels), batch_size):
            x = to_device(pixels[start:start + batch_size], dev)
            with torch.no_grad():
                r = residual(x.to(torch.float32)).cpu().numpy()
            parts += [np.abs(subset_residual(ri, names[i], num_pixels))
                      for i, ri in enumerate(r, start)]
        results[label] = np.concatenate(parts)
    return results


def box_stats(results: "collections.OrderedDict[str, np.ndarray]",
              anchor: str) -> typing.List[dict]:
    """Rows ``{Type, edge_interval, *STATS}`` of every non-empty bucket,
    sorted by (edge_interval, Type) as strings: every population ordered
    by the anchor's error and split where it passes ``EDGE_VALUES``."""
    order = np.argsort(results[anchor])
    points = collections.OrderedDict(
        (k, v.flatten()[order]) for k, v in results.items())
    edges = [np.argmin(points[anchor] <= e) - 1 for e in EDGE_VALUES]
    edges = [0] + edges + [len(points[anchor])]
    edge_values = [0] + EDGE_VALUES + [np.inf]

    rows = []
    for k, x in points.items():
        for j in range(len(edges) - 1):
            v = x[edges[j]:edges[j + 1]].astype("float64")
            if not len(v):
                continue
            q25, q50, q75 = (np.percentile(v, q) for q in (25.0, 50.0, 75.0))
            lo, hi = v.min(), v.max()
            rows.append(dict(zip(
                ("Type", "edge_interval") + STATS,
                (k, f"{edge_values[j]}-{edge_values[j + 1]}", lo,
                 np.clip(q25 - 1.5 * (q75 - q25), lo, hi), q25, q50, q75,
                 np.clip(q75 + 1.5 * (q75 - q25), lo, hi), hi))))
    return sorted(rows, key=lambda r: (r["edge_interval"], r["Type"]))


def bucket_quantiles(results, anchor: str) -> Table:
    """``box_stats`` as the table of ``ae_boxes_3.csv``."""
    rows = box_stats(results, anchor)
    if not rows:
        return Table({k: [] for k in ("Type", "edge_interval", *STATS)})
    return from_rows(rows)


def run_error_boxes(
    data_path: pathlib.Path,
    model_dir: pathlib.Path = None,
    split: str = "split_te.csv",
    shuffle_seed: int = 12345,
    num_pixels: int = None,
    num_images: int = None,
    unet_models: typing.Sequence[typing.Tuple[str, str]] = UNET_MODELS,
    outfile: pathlib.Path = None,
    batch_size: int = 8,
    fast_conv=False,
    device=None,
) -> Table:
    """The analysis over a split: the ``ae_boxes_3.csv`` table, written
    with its figure (``outfile`` with ``.png``) when ``outfile`` is given.
    A U-Net method without a run is skipped."""
    from ..data.catalog import precovers

    df = precovers(data_path, split=split, shuffle_seed=shuffle_seed,
                   take_num_images=num_images)
    unets = []
    for method, label in unet_models or ():
        for _, run in unet_runs(model_dir, [method]):
            unets.append((label, run))
    results = residual_populations(
        data_path, list(df["name"]), unets=unets, num_pixels=num_pixels,
        batch_size=batch_size, fast_conv=fast_conv, device=device)
    out = bucket_quantiles(results, anchor="KB")
    if outfile is not None:
        outfile = pathlib.Path(outfile)
        outfile.parent.mkdir(parents=True, exist_ok=True)
        out.to_csv(outfile)
        _plot(results, outfile.with_suffix(".png"))
    return out


def _plot(results, outfile):
    """The square-root-scaled boxplot of the buckets, as the JAX package
    draws it, where matplotlib and seaborn (with pandas) are installed;
    without them, one line on stderr says the figure was not drawn."""
    mods = plotting("error-boxes", outfile, "matplotlib.pyplot", "pandas",
                    "seaborn")
    if mods is None:
        return
    matplotlib, plt, pd, sns = mods

    frames = []
    order = np.argsort(results["KB"])
    edges = [np.argmin(results["KB"][order] <= e) - 1 for e in EDGE_VALUES]
    edges = [0] + edges + [len(order)]
    edge_values = [0] + EDGE_VALUES + [np.inf]
    for k, v in results.items():
        x = v.flatten()[order]
        for j in range(len(edges) - 1):
            frames.append(pd.DataFrame({
                "Type": k,
                "edge_interval": f"{edge_values[j]}-{edge_values[j + 1]}",
                "values": x[edges[j]:edges[j + 1]],
            }))
    df = pd.concat(frames)
    fig, ax = plt.subplots()
    sns.boxplot(df, x="edge_interval", y="values", hue="Type",
                flierprops={"marker": "x", "alpha": .1}, ax=ax)
    ax.set_ylim(0, 64)
    ax.set_yscale("function", functions=(np.sqrt, np.square))
    ax.yaxis.set_major_locator(matplotlib.ticker.FixedLocator(
        [0, 1, 4, 9, 16, 25, 36, 49, 64]))
    ax.set_xlabel("Pixels at given AE of KB_gray filter")
    ax.set_ylabel("Absolute Error (AE)")
    fig.savefig(outfile, dpi=300, bbox_inches="tight")
    plt.close(fig)
