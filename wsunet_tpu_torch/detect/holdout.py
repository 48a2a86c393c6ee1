"""Leak-free cross-fold pooled detection evaluation (port of
``wsunet_tpu/detect/holdout.py``, on ``utils.table`` tables: no pandas;
both functions take ``device``, None = CUDA, and every file they write
holds pandas' bytes for the JAX package's frames).

The reference's golden detection numbers come from models trained on a
disjoint corpus (BOSS) and evaluated on the bundled fixture (the
reference's LSBR U-Net config names the BOSS dataset; its
results/detection/auc_0.01.csv is fixture-evaluated).
When models are trained on the fixture itself, an honest comparison needs
train/eval cover disjointness.  This module implements the protocol:

- the fixture covers are partitioned into folds;
- each fold's models are trained ONLY on that fold's covers (end-of-
  schedule checkpoints, validation inside the training fold — checkpoint
  selection is part of training);
- each trained model is scored ONLY on rows of covers it never saw
  (``eval_split``), and scores from all folds are pooled under a shared
  label into one full-coverage detection table.

Weight-free detectors (the fixed AVG/KB filters) have no training covers
and are scored on the full catalog once.  OLS is fitted at eval time, so
in a holdout sweep its taps are fitted per fold on ``Fold.train_split``
covers and scored on that fold's eval covers like any trained detector.

Outputs mirror the reference's auc/roc schema (src/ws/roc.py:198-283 via
detect.roc.produce_roc) with an extra per-image provenance frame so the
cover-disjointness of every pooled score can be audited.
"""

import dataclasses
import pathlib
import typing

import numpy as np

from ..utils.table import Table, concat, fillna, isna


@dataclasses.dataclass
class Fold:
    """Models of one training fold plus the rows they may be scored on.

    ``eval_split``: CSV (files.csv schema) holding ONLY rows whose covers
    are outside this fold's training set.
    ``unets``: label -> (model_path, model_name); model_path is the
    method-level directory holding the run (e.g. weights/unet/LSBR).
    ``b0s``: label -> dict(model_dir=..., stego_method=..., model_name=...,
    lsbr_reference=bool); model_dir is the family root (e.g. weights/b0).
    ``train_split``: CSV of the fold's TRAINING covers — used by detectors
    fitted at eval time (OLS) so their fit stays inside the fold.
    """

    eval_split: str
    unets: typing.Dict[str, typing.Tuple[pathlib.Path, str]] = \
        dataclasses.field(default_factory=dict)
    b0s: typing.Dict[str, dict] = dataclasses.field(default_factory=dict)
    train_split: str = None


def holdout_frames(
    data_path: pathlib.Path,
    folds: typing.Sequence[Fold],
    filter_models: typing.Sequence[str] = ("AVG", "KB"),
    stego_methods: typing.Sequence[str] = ("LSBR", "HILLR"),
    alphas: typing.Sequence[float] = (0.1, 0.05, 0.01),
    batch_size: int = 8,
    device=None,
) -> Table:
    """Per-image detector scores with fold provenance.

    Columns follow the roc-sweep contract (model_name, stego_method,
    alpha, score/beta_hat) plus ``fold`` (the eval split each row came
    from; weight-free filters carry fold="all").
    """
    from ..ws import ws_run

    frames = []

    def ws_sweep(model_name, model_path, label, split, fold_tag,
                 ols_fit_split=None):
        for sm in [None, *stego_methods]:
            for alpha in (alphas if sm else [None]):
                res = ws_run(
                    input_dir=data_path, stego_method=sm, alpha=alpha,
                    model_name=model_name, model_path=model_path,
                    model_label=label, weighted=0, batch_size=batch_size,
                    split=split, ols_fit_split=ols_fit_split,
                    device=device)
                res["fold"] = fold_tag
                frames.append(res)

    for name in filter_models:
        if name == "OLS":
            # OLS is fitted at eval time, so unlike the fixed named
            # filters it HAS training covers: fit on each fold's
            # train_split, score only that fold's eval covers
            for fi, fold in enumerate(folds):
                if fold.train_split is None:
                    raise ValueError(
                        "OLS in a holdout sweep needs Fold.train_split")
                ws_sweep(name, None, name, fold.eval_split, f"fold{fi}",
                         ols_fit_split=fold.train_split)
        else:
            ws_sweep(name, None, name, None, "all")

    from .b0_eval import run as b0_run

    for fi, fold in enumerate(folds):
        tag = f"fold{fi}"
        for label, (model_path, model_name) in fold.unets.items():
            ws_sweep(model_name, model_path, label, fold.eval_split, tag)
        for label, spec in fold.b0s.items():
            res = b0_run(
                data_path, spec["model_dir"],
                spec.get("stego_method", "LSBR"),
                # keep B0 coverage symmetric with the WS sweeps when a
                # caller narrows stego_methods (ADVICE r3)
                eval_methods=stego_methods,
                model_name=spec["model_name"],
                lsbr_reference=spec.get("lsbr_reference", False),
                batch_size=batch_size, split=fold.eval_split,
                device=device)
            res = res[isna(res["stego_method"]) |
                      np.isin(res["alpha"], list(alphas))]
            res["model_name"] = label
            res["score"] = res["output"]
            res["fold"] = tag
            frames.append(res)

    res = concat(frames)
    res["stego_method"] = fillna(res["stego_method"], "Cover")
    res["alpha"] = fillna(res["alpha"], 0.0)
    return res


def holdout_roc(
    data_path: pathlib.Path,
    folds: typing.Sequence[Fold],
    results_dir: pathlib.Path = None,
    suffix: str = "holdout",
    **kw,
) -> Table:
    """Pooled held-out ROC/AUC table; optionally writes the
    ``auc_<alpha>_<suffix>.csv`` / ``roc_<alpha>_<suffix>.csv`` artifacts
    plus the per-image ``scores_<suffix>.csv`` audit frame.  ``kw`` goes
    to ``holdout_frames``."""
    from .roc import AUC_COLUMNS, produce_roc, roc_curves

    scores = holdout_frames(data_path, folds, **kw)
    df_roc = produce_roc(scores)
    df_auc = df_roc[AUC_COLUMNS].drop_duplicates()
    if results_dir is not None:
        alpha = min(kw.get("alphas", (0.1, 0.05, 0.01)))
        outdir = pathlib.Path(results_dir) / "detection"
        outdir.mkdir(parents=True, exist_ok=True)
        df_auc.to_csv(outdir / f"auc_{alpha}_{suffix}.csv")
        # bootstrap uncertainty for the published point estimates (the
        # table is small-n by design; detect/ci.py quantifies it)
        from .ci import bootstrap_roc_cis
        bootstrap_roc_cis(scores).to_csv(
            outdir / f"auc_{alpha}_{suffix}_ci.csv")
        roc_curves(df_roc).to_csv(outdir / f"roc_{alpha}_{suffix}.csv")
        # per-alpha breakout: the pooled table mixes easy and hard change
        # rates (golden-artifact semantics); this sidecar shows each
        # detector's AUC/P_E per single alpha so claims about the hardest
        # cell (alpha=0.01 alone) are auditable from a committed artifact
        by_alpha = []
        for a in sorted(kw.get("alphas", (0.1, 0.05, 0.01))):
            sub = scores[(scores["alpha"] == 0.0) | (scores["alpha"] == a)]
            t = produce_roc(sub)[["stego_method", "model_name", "auc",
                                  "p_e"]].drop_duplicates()
            t.insert(0, "alpha", a)
            by_alpha.append(t)
        concat(by_alpha).to_csv(outdir / f"auc_by_alpha_{suffix}.csv")
        audit_cols = [c for c in ("name", "fold", "model_name",
                                  "stego_method", "alpha", "beta_hat",
                                  "score") if c in scores.columns]
        scores[audit_cols].to_csv(outdir / f"scores_{suffix}.csv")
    return df_auc
