"""The detection meters ``produce_roc`` uses and the streaming meters of
the trainer (port of part of ``wsunet_tpu/detect/metrics.py``), in numpy
alone.

The trainer's meters (``AverageMeter``, ``LossMeter``, ``MAEMeter``,
``WSMeter``, ``ProgressMeter``, and the B0 trainer's ``AccuracyMeter``)
take numpy arrays or host numbers; ``WSMeter`` takes the port's NCHW
batches and crops 1 px of H and W.

The JAX package computes them with scikit-learn, which the card's machine
does not have.  ``roc_curve`` and ``auc`` here return what
``sklearn.metrics.roc_curve`` and ``sklearn.metrics.auc`` return: every
distinct score in decreasing order is a threshold (with
``drop_intermediate=False``, which every meter passes), a first point
(0, 0) with threshold ``inf`` is prepended, and rates with no positive or
no negative sample are NaN.  ``wAUCMeter`` splits the curve at an index of
those points and ``PMD5FPMeter`` steps back from one, so an extra or a
missing point moves them.
"""

from enum import Enum

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Summary(Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    """Streaming average."""

    name = None

    def __init__(self, fmt=":.5f", summary_type=Summary.AVERAGE):
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def update_vector(self, vals):
        vals = np.asarray(vals)
        self.sum += np.nansum(vals)
        self.count += vals.shape[0]
        self.avg = self.sum / self.count

    def __str__(self):
        if self.summary_type is Summary.NONE:
            return ""
        field = {Summary.AVERAGE: "avg", Summary.SUM: "sum",
                 Summary.COUNT: "count"}[self.summary_type]
        return f"{self.name} {getattr(self, field):.3f}"


class LossMeter(AverageMeter):
    name = "loss"


class MAEMeter(AverageMeter):
    """Masked mean absolute error, times ``multiplier``."""

    name = "mae"

    def __init__(self, *args, multiplier: int = 1, masked: bool = None, **kw):
        super().__init__(*args, **kw)
        self.multiplier = multiplier
        self.masked = masked

    def update(self, y_true, y_pred, mask=None):
        if self.masked is True:
            y_true, y_pred = y_true[mask], y_pred[mask]
        elif self.masked is False:
            y_true, y_pred = y_true[~mask], y_pred[~mask]
        resid = (np.asarray(y_true) - np.asarray(y_pred)) * self.multiplier
        super().update(np.nanmean(np.abs(resid)))


class WSMeter(AverageMeter):
    """beta_hat MAE on [B, C, H, W] batches in [0, 1]: a 1-px crop of H
    and W, round then XOR 1, uniform weights, clipped at 0 (the JAX meter
    crops axes 1 and 2 of its NHWC batches, the same pixels)."""

    name = "ws"

    def update(self, x, x_hat, alphas):
        x = np.asarray(x)[..., 1:-1, 1:-1] * 255.0
        x_hat = np.asarray(x_hat)[..., 1:-1, 1:-1] * 255.0
        x_bar = np.round(x).astype("int") ^ 1
        weights = np.ones_like(x) / np.prod(x.shape[1:])
        axes = tuple(range(1, x.ndim))
        betas_hat = np.sum(weights * (x - x_bar) * (x - x_hat), axis=axes)
        betas_hat = np.clip(betas_hat, 0, None)
        betas = np.asarray(alphas) / 2.0
        super().update(np.mean(np.abs(betas_hat - betas)))


class ProgressMeter:
    """Batch-progress line formatter."""

    def __init__(self, num_batches, meters, prefix=""):
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def to_str(self, batch):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)


def roc_curve(y_true, y_score, pos_label=1, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) of a binary score, as scikit-learn's
    ``roc_curve`` (float64 cumulative counts, stable ordering of ties)."""
    y_true = np.asarray(y_true).ravel() == pos_label
    y_score = np.asarray(y_score).ravel()
    if not np.all(np.isfinite(y_score)):
        raise ValueError("scores must be finite")
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]
    if drop_intermediate and len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                   np.diff(tps, 2)),
                              True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = np.repeat(np.nan, fps.shape) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.repeat(np.nan, tps.shape) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Trapezoid area under (x, y), x monotonic (scikit-learn's ``auc``)."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape[0] < 2:
        raise ValueError("at least 2 points are needed to compute the area "
                         f"under a curve, got {x.shape[0]}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
    return float(direction * _trapezoid(y, x))


def roc_auc_score(y_true, y_score) -> float:
    """Binary ROC AUC, as scikit-learn's ``roc_auc_score`` (the
    Mann-Whitney statistic with ties counted one half)."""
    y_true = np.asarray(y_true)
    if len(np.unique(y_true)) != 2:
        raise ValueError("only one class present in y_true; ROC AUC is not "
                         "defined then")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


class PerformanceMeter:
    """Accumulate-all meter base."""

    name = None

    def __init__(self):
        self.reset()

    def reset(self):
        self.y_pred = np.array([])
        self.y_true = np.array([])

    def update(self, y_true, y_pred):
        self.y_pred = np.concatenate((self.y_pred, np.asarray(y_pred)))
        self.y_true = np.concatenate((self.y_true, np.asarray(y_true)))

    @property
    def avg(self):
        raise NotImplementedError

    def __str__(self):
        return f"{self.name}: {self.avg:4.3f}"

    def to_dict(self):
        return {self.name: self.avg}


class AccuracyMeter(PerformanceMeter):
    """Share of predicted labels equal to the true ones."""

    name = "accuracy"

    @property
    def avg(self):
        return np.mean(self.y_pred == self.y_true)


class PEMeter(PerformanceMeter):
    """Minimum-error P_E from the ROC."""

    name = "p_e"

    @property
    def avg(self):
        fpr, tpr, _ = roc_curve(self.y_true, self.y_pred, pos_label=1,
                                drop_intermediate=False)
        if np.isnan(fpr).any() or np.isnan(tpr).any():
            return np.nan
        P = 0.5 * (fpr + (1 - tpr))
        return min(P[P > 0])


class PMD5FPMeter(PerformanceMeter):
    """Missed detection at 5% false positives."""

    name = "p_md^5fp"

    @property
    def avg(self):
        fpr, tpr, _ = roc_curve(self.y_true, self.y_pred, pos_label=1,
                                drop_intermediate=False)
        tau_idx = np.argmax(fpr > .05)
        if fpr[tau_idx] > .05:
            tau_idx -= 1
        return 1 - tpr[tau_idx]


class AUCMeter(PerformanceMeter):
    name = "auc"

    @property
    def avg(self):
        return roc_auc_score(self.y_true, self.y_pred)


class wAUCMeter(PerformanceMeter):
    """ALASKA-style weighted AUC: the area below TPR 0.4 counts twice."""

    name = "wauc"

    @property
    def avg(self):
        fpr, tpr, _ = roc_curve(self.y_true, self.y_pred, pos_label=1,
                                drop_intermediate=False)
        if np.isnan(fpr).any() or np.isnan(tpr).any():
            return np.nan
        idx = np.argmin(tpr < .4)
        alpha_beta_p4 = fpr[idx]
        if idx < 2 or len(fpr) - idx < 2:
            # fewer than 2 points on a side: undefined, as for NaN inputs
            return np.nan
        auc_a = auc(fpr[:idx], tpr[:idx])
        auc_b = auc(fpr[idx:], tpr[idx:])
        return (auc_a * 2 + auc_b) / (1 + alpha_beta_p4)
