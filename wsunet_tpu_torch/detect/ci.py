"""Bootstrap confidence intervals for the detection tables (port of
``wsunet_tpu/detect/ci.py``, numpy only; the same ``SEED`` and the same
arithmetic in the same order, so the same input gives the same output,
bit for bit, and the table (``utils.table``) writes pandas' bytes).

The fixture protocol scores a handful of covers per fold (the holdout
table pools 5 covers x 3 alphas per method), so a point AUC of 1.000 or
0.400 carries real sampling noise.  The reference publishes none of this
uncertainty; here every holdout AUC/P_E ships with a stratified-bootstrap
percentile interval so the small-n caveat is quantified instead of
hand-waved.

Method: resample covers and stegos independently with replacement
(stratified — class balance is fixed by the sweep design, not estimated),
recompute the detector statistic per resample with the SAME math as the
published point estimate (the 501-threshold grid of
``detect.roc.produce_roc`` / reference src/ws/roc.py:198-283, including
its tie-aware rank-AUC fallback for degenerate resamples where the FPR
never moves), and report percentile quantiles.  Everything is vectorized
over resamples via per-image multinomial counts, so 10k resamples of a
20-image group cost milliseconds.
"""

import numpy as np

from ..utils.table import Table, from_rows
from .roc import TAUS, iter_detector_groups, scores_and_labels

N_BOOT = 10_000
SEED = 20_260_818  # deterministic: committed artifacts must reproduce


def _grid_indicators(y_hat: np.ndarray) -> np.ndarray:
    """[N, 501] strictly-greater threshold indicators, float64, on the
    exact grid the published point estimates use (detect.roc.TAUS)."""
    return (y_hat[:, None] > TAUS[None, :]).astype(np.float64)


def _counts(rng, n_boot: int, n: int) -> np.ndarray:
    """[n_boot, n] multinomial resample counts (rows sum to n)."""
    idx = rng.integers(0, n, size=(n_boot, n))
    counts = np.zeros((n_boot, n), np.float64)
    np.add.at(counts, (np.repeat(np.arange(n_boot), n), idx.ravel()), 1.0)
    return counts


def bootstrap_auc_pe(y_hat: np.ndarray, y: np.ndarray,
                     n_boot: int = N_BOOT, seed: int = SEED,
                     level: float = 0.95) -> dict:
    """Stratified-bootstrap percentile CIs for the grid AUC and P_E of
    one detector group.  Returns auc_lo/auc_hi/p_e_lo/p_e_hi plus the
    class sizes the interval is conditioned on."""
    pos = np.asarray(y) > 0.0
    y_hat = np.asarray(y_hat, np.float64)
    sp, sn = y_hat[pos], y_hat[~pos]
    if len(sp) == 0 or len(sn) == 0:
        return {"n_cover": int((~pos).sum()), "n_stego": int(pos.sum()),
                "auc_lo": np.nan, "auc_hi": np.nan,
                "p_e_lo": np.nan, "p_e_hi": np.nan}

    ind_p, ind_n = _grid_indicators(sp), _grid_indicators(sn)
    rng = np.random.default_rng(seed)
    cp = _counts(rng, n_boot, len(sp))
    cn = _counts(rng, n_boot, len(sn))
    tpr = cp @ ind_p / len(sp)  # [n_boot, 501]
    fpr = cn @ ind_n / len(sn)

    # same AUC formula as produce_roc: fpr-bin-normalized tpr sum,
    # rank-AUC fallback when the fpr never moves across the grid
    bins = np.diff(fpr, axis=1, prepend=fpr[:, :1])
    s = bins.sum(axis=1)
    auc = np.full(n_boot, np.nan)
    ok = s > 0
    auc[ok] = np.einsum("bt,bt->b", bins[ok] / s[ok, None], tpr[ok])
    if (~ok).any():
        # pairwise tie-aware comparison matrix, weighted by resample
        # counts: mean over pairs of 1[sp>sn] + 0.5*1[sp==sn]
        G = ((sp[:, None] > sn[None, :]).astype(np.float64)
             + 0.5 * (sp[:, None] == sn[None, :]))
        auc[~ok] = (np.einsum("bp,pn,bn->b", cp[~ok], G, cn[~ok])
                    / (len(sp) * len(sn)))

    p_e = ((1.0 - tpr + fpr) / 2.0).min(axis=1)
    q_lo, q_hi = (1 - level) / 2, 1 - (1 - level) / 2
    return {
        "n_cover": int(len(sn)), "n_stego": int(len(sp)),
        "auc_lo": float(np.quantile(auc, q_lo)),
        "auc_hi": float(np.quantile(auc, q_hi)),
        "p_e_lo": float(np.quantile(p_e, q_lo)),
        "p_e_hi": float(np.quantile(p_e, q_hi)),
    }


def bootstrap_roc_cis(df_ws, n_boot: int = N_BOOT, seed: int = SEED,
                      level: float = 0.95) -> Table:
    """Per-(stego_method, model_name) CI table for a sweep's rows (a table
    or a DataFrame; the same grouping and score conventions as
    produce_roc)."""
    out = []
    for stego_method, model_name, df_i in iter_detector_groups(df_ws):
        y_hat, y = scores_and_labels(df_i, model_name)
        row = {"stego_method": stego_method, "model_name": model_name}
        row.update(bootstrap_auc_pe(y_hat, y, n_boot=n_boot, seed=seed,
                                    level=level))
        out.append(row)
    return from_rows(out)
