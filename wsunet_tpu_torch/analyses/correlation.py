"""Residual <-> embedding-change correlation (port of
``wsunet_tpu/analyses/correlation.py``).

For each cover-stego pair: the Pearson-style correlation between the
embedding change ``d_s = stego - cover`` (border-cropped) and the
predictor's residual ``dhat_c = predict(stego) - cover``, and a one-sided
t-test p-value.  As in the JAX package, the normaliser is ``x_hat.std()``
(the prediction's), not ``dhat_c.std()``; ``orthodox=True`` takes the
latter.

- ``pair_correlation``: one pair, numpy and scipy (imported inside).
- ``correlation_rows``: the per-pair rows over image names, with a
  ``reader=`` and a ``device=``: each named filter (``ops.filter_predict``)
  and each trained U-Net (``ws.unet_eval.get_unet_estimator``, on B1 with
  ``fast_conv=True``) predicts the stegos in batches of ``batch_size``.
  The JAX package predicts every stego in one call; the math is per
  image, so the rows are the same.  No pandas.
- ``run_correlation``: the catalog edge: the pairs of a dataset, the runs
  found by name, the rows as a table (``utils.table``) and
  ``median_table``, the table of ``correlation.csv``.  No pandas.
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..data.pipeline import load_images
from ..io import imread_gray_u8
from ..ops.filters import NAMED_FILTERS_2D, filter_predict
from ..train.checkpoint import load_config
from ..utils.registry import get_model_name
from ..utils.table import Table, from_rows, isna
from ..ws.unet_eval import get_unet_estimator

FILTERS = ("1", "AVG9", "AVG", "KB")
UNET_METHODS = ("dropout", "LSBR", "HILLR")


def pair_correlation(
    x_c: np.ndarray,
    x_s: np.ndarray,
    x_hat: np.ndarray,
    orthodox: bool = False,
) -> typing.Tuple[float, float]:
    """(correlation, p-value) for one pair; all arrays [H, W] cropped
    consistently (x_hat already border-cropped by the predictor)."""
    import scipy.stats

    d_s = (x_s - x_c)[1:-1, 1:-1]
    dhat_c = x_hat - x_c[1:-1, 1:-1]
    cov = np.sum((dhat_c - dhat_c.mean()) * (d_s - d_s.mean())) / (d_s.size - 1)
    denom = dhat_c.std() if orthodox else x_hat.std()
    cor = cov / denom / d_s.std()
    test_val = np.abs(cor) / np.sqrt(1 - cor ** 2) * np.sqrt(d_s.size - 2)
    pval = scipy.stats.t.sf(test_val, d_s.size - 2)
    return float(cor), float(pval)


def unet_runs(model_dir, methods) -> list:
    """``(label, run directory)`` of the trained U-Net of each method,
    labelled ``UNet_<method>_<loss>``; a method without a run (or no
    ``model_dir``) is skipped, as in the JAX package."""
    runs = []
    for method in methods or ():
        try:
            name = get_model_name(model_dir, method)
        except (RuntimeError, TypeError):
            continue
        run = pathlib.Path(model_dir) / method / name
        runs.append((f"UNet_{method}_{load_config(run).get('loss', '')}",
                     run))
    return runs


def correlation_rows(
    root: pathlib.Path,
    names_c: typing.Sequence[str],
    names_s: typing.Sequence[str],
    filter_names: typing.Sequence[str] = FILTERS,
    unets: typing.Sequence[typing.Tuple[str, pathlib.Path]] = (),
    orthodox: bool = False,
    batch_size: int = 8,
    fast_conv=False,
    reader: typing.Callable = imread_gray_u8,
    device=None,
) -> typing.List[dict]:
    """Rows ``{name_c, name_s, correlation, p-value, model_name}`` of every
    pair for each filter, then each ``(label, run directory)`` of
    ``unets``; the stegos are predicted on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    covers = load_images(root, names_c, reader=reader).astype("float32")
    stegos = load_images(root, names_s, reader=reader)
    predictors = [(name, lambda x, k=NAMED_FILTERS_2D[name]:
                   filter_predict(x, k)) for name in filter_names]
    predictors += [(label, get_unet_estimator(run.parent, run.name,
                                              fast_conv=fast_conv,
                                              device=dev))
                   for label, run in unets]
    rows = []
    for label, predict in predictors:
        for start in range(0, len(stegos), batch_size):
            x = to_device(stegos[start:start + batch_size], dev)
            with torch.no_grad():
                x_hat = predict(x.to(torch.float32)).cpu().numpy()
            for i, xh in enumerate(x_hat, start):
                cor, pval = pair_correlation(
                    covers[i], stegos[i].astype("float32"), xh,
                    orthodox=orthodox)
                rows.append({"name_c": names_c[i], "name_s": names_s[i],
                             "correlation": cor, "p-value": pval,
                             "model_name": label})
    return rows


def median_table(res: Table) -> Table:
    """The median correlation and p-value of each model over its pairs
    (NaN skipped): a column ``''`` naming the two rows, then one column a
    model in the order the models first appear, so that ``to_csv`` writes
    the JAX package's ``correlation.csv`` (the transposed
    ``groupby("model_name").median()`` written with its index)."""
    med = res.medians("model_name", ["correlation", "p-value"])
    at = {m: i for i, m in enumerate(med["model_name"])}
    out = Table({"": ["correlation", "p-value"]}, n=2)
    for m in dict.fromkeys(res["model_name"]):
        out[m] = np.array([med["correlation"][at[m]],
                           med["p-value"][at[m]]], np.float64)
    return out


def run_correlation(
    data_path: pathlib.Path,
    model_dir: pathlib.Path = None,
    filter_names=FILTERS,
    unet_methods=UNET_METHODS,
    stego_method: str = "LSBR",
    alpha: float = 1.0,
    orthodox: bool = False,
    split: str = None,
    take_num_images: int = None,
    batch_size: int = 8,
    fast_conv=False,
    device=None,
) -> typing.Tuple[Table, Table]:
    """Sweep the filters and the trained U-Nets over a dataset's pairs:
    (per-pair rows, ``median_table``), the table ``correlation.csv``
    holds."""
    from ..data.catalog import cover_stego_pairs

    df = cover_stego_pairs(data_path, stego_method=stego_method, alpha=alpha,
                           split=split, take_num_images=take_num_images)
    df = df[~isna(df["name_s"])]
    res = from_rows(correlation_rows(
        data_path, list(df["name_c"]), list(df["name_s"]),
        filter_names=filter_names,
        unets=unet_runs(model_dir, unet_methods), orthodox=orthodox,
        batch_size=batch_size, fast_conv=fast_conv, device=device))
    return res, median_table(res)
