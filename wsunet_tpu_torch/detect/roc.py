"""ROC / AUC / P_E tables (port of ``wsunet_tpu/detect/roc.py``).

``roc_stats`` is the per-detector arithmetic, numpy alone: the 501-point
threshold sweep tau in reversed(linspace(0, 1, 501)) with strict ``>``,
the AUC from fpr-bin-normalised tpr sums (with the tie-aware rank AUC when
the FPR never moves), P_E = min (1 - tpr + fpr) / 2 and its tau0, the
operating point at tau = 0.5, and the wAUC and P_MD@5%FP meters.  P_E
comes from this sweep, not from ``metrics.PEMeter``.  ``produce_roc`` wraps
it into one table (``utils.table``) with the JAX package's DataFrame's
columns, one group per (stego method, model); ``roc_curves`` is the
``roc`` command's pivot of it.
"""

import numpy as np

from ..utils.table import Table, as_table, concat
from .metrics import PMD5FPMeter, roc_auc_score, wAUCMeter

TAUS = np.linspace(0, 1, 501, endpoint=True)[::-1]
# the columns of the AUC tables (``auc_<alpha>.csv``): one row a detector
AUC_COLUMNS = ["stego_method", "model_name", "auc", "p_e", "wauc", "pmd_5fp",
               "tau0", "fpr_tau0", "tpr_tau0", "fpr_50", "tpr_50"]


def iter_detector_groups(df_ws):
    """(stego_method, model_name, group table) per detector, in the sorted
    order of the (stego_method, model_name) keys: the model's rows for the
    method plus all its cover rows.  ``df_ws`` is a table or a
    DataFrame."""
    df_ws = as_table(df_ws)
    for (stego_method, model_name), _ in df_ws.groups(
            ["stego_method", "model_name"]):
        if stego_method == "Cover":
            continue
        df_i = df_ws[df_ws["model_name"] == model_name]
        yield (stego_method, model_name,
               df_i[np.isin(df_i["stego_method"], [stego_method, "Cover"])])


def _roc_curve_manual(y_hat: np.ndarray, y: np.ndarray):
    taus = TAUS
    pos = y > 0.0
    neg = ~pos
    above = y_hat[None, :] > taus[:, None]  # [501, N]
    TP = np.sum(above & pos[None, :], axis=1)
    FP = np.sum(above & neg[None, :], axis=1)
    FN = pos.sum() - TP
    TN = neg.sum() - FP
    tpr = TP / (TP + FN)
    fpr = FP / (FP + TN)
    return taus, tpr, fpr


def scores_and_labels(df_i, model_name: str):
    """Scores and soft labels of one group: B0 detectors ('B0' in the
    name) score with their softmax column and label with alpha; WS
    detectors with clipped beta_hat and alpha / 2."""
    alpha = np.asarray(df_i["alpha"], np.float64)
    if "B0" in model_name:
        return np.asarray(df_i["score"]), alpha
    return np.clip(np.asarray(df_i["beta_hat"]), 0, None), alpha / 2


def roc_stats(y_hat: np.ndarray, y: np.ndarray) -> dict:
    """The ROC table of one detector from its scores ``y_hat`` and labels
    ``y`` (stego where y > 0): the curve (tau, tpr, fpr, 501 points each)
    and the scalars auc, p_e, tau0, fpr_tau0, tpr_tau0, fpr_50, tpr_50,
    wauc and pmd_5fp."""
    y_hat, y = np.asarray(y_hat), np.asarray(y)
    taus, tpr, fpr = _roc_curve_manual(y_hat, y)

    bins = np.diff(fpr, prepend=fpr[0])
    bins_sum = bins.sum()
    if bins_sum > 0:
        bins = bins / bins_sum
        auc = np.sum(bins * tpr)
    elif len(np.unique(y > 0)) < 2:
        # one class only: both the formula and the rank AUC are undefined
        auc = float("nan")
    else:
        # the FPR never moves (every cover scores 0 under strict ">"), so
        # the formula is undefined: the tie-aware rank statistic
        auc = float(roc_auc_score((y > 0).astype(int), y_hat))
    tau0_idx = np.argmin((1 - tpr + fpr) / 2)
    p_e = ((1 - tpr + fpr) / 2)[tau0_idx]
    pos, neg = y > 0.0, y <= 0.0
    TP = np.sum((y_hat > .5) & pos)
    FP = np.sum((y_hat > .5) & neg)
    TN = np.sum((y_hat <= .5) & neg)
    FN = np.sum((y_hat <= .5) & pos)

    wauc_m, pmd_m = wAUCMeter(), PMD5FPMeter()
    wauc_m.update((y > 0).astype(int), y_hat)
    pmd_m.update((y > 0).astype(int), y_hat)
    return {"tau": taus, "tpr": tpr, "fpr": fpr, "p_e": p_e,
            "tau0": taus[tau0_idx], "fpr_tau0": fpr[tau0_idx],
            "tpr_tau0": tpr[tau0_idx], "auc": auc,
            "fpr_50": FP / (FP + TN), "tpr_50": TP / (TP + FN),
            "wauc": wauc_m.avg, "pmd_5fp": pmd_m.avg}


def produce_roc(df_ws) -> Table:
    """Per-detector ROC tables of a sweep's rows (a table or a DataFrame),
    one table: 501 rows a detector, its curve and its scalars."""
    out = []
    for stego_method, model_name, df_i in iter_detector_groups(df_ws):
        stats = roc_stats(*scores_and_labels(df_i, model_name))
        label = model_name if "B0" in model_name else f"WS-{model_name}"
        out.append(Table({"stego_method": stego_method,
                          "model_name": model_name, **stats,
                          "label": label}, n=len(TAUS)))
    return concat(out)


def roc_curves(df_roc: Table) -> Table:
    """The curves of ``produce_roc``'s table side by side, one row a
    threshold in ascending order: ``tpr_<method>_<model>`` for each
    detector in sorted order, then ``fpr_...`` (``DataFrame.pivot(index=
    "tau", columns=["stego_method", "model_name"], values=["tpr",
    "fpr"])`` with its columns joined by "_")."""
    groups = list(df_roc.groups(["stego_method", "model_name"]))
    out = Table(n=len(TAUS))
    for value in ("tpr", "fpr"):
        for (stego_method, model_name), g in groups:
            g = g.sort("tau")
            out[f"{value}_{stego_method}_{model_name}".strip()] = g[value]
    return out