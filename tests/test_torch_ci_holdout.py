"""Port parity: the bootstrap intervals (wsunet_tpu_torch.detect.ci) and
the leak-free cross-fold tables (wsunet_tpu_torch.detect.holdout) against
the JAX package's, on the CPU.

``bootstrap_auc_pe`` / ``bootstrap_roc_cis`` are numpy in both packages
with the same seed: equal bit for bit.  The holdout frames run KB (weight
free, one pass over the catalog), OLS fitted per fold on the fold's
training covers, and the committed strided LSBR B0 per fold, over two
folds made from ``data_ablation/p128/split_{tr,va}.csv`` on a catalog of
32 covers (fold 0 scores the 16 covers of split_va and their stego and
fits on the other 16; fold 1 the reverse).  Scores are held as in tests/test_torch_runs.py (KB
rtol 1e-4 / atol 1e-6), tests/test_torch_ols.py (OLS 2e-4) and
tests/test_torch_b0.py (P(stego) 1e-4).  The tables ``holdout_roc`` writes
equal JAX's on the same scores bit for bit, and their files JAX's byte for
byte, also where the port runs in a process without pandas, PIL, cv2,
matplotlib or seaborn (``blocked_roc``); on each package's own scores
they agree within one near-tie
(``test_pooled_roc_within_a_near_tie_of_jax``).  The port's functions
return ``utils.table`` tables, compared through ``frame``.
"""

import numpy as np
import pandas as pd
import pytest

from torch_p128 import (LOAD_TABLE, P128, REPO, frame, make_catalog,
                        run_without_host_packages, save_columns)
from wsunet_tpu.detect import Fold as JaxFold
from wsunet_tpu.detect import ci as jax_ci
from wsunet_tpu.detect import holdout_frames as jax_holdout_frames
from wsunet_tpu.detect.holdout import holdout_roc as jax_holdout_roc
from wsunet_tpu_torch.detect import (Fold, bootstrap_auc_pe,
                                     bootstrap_roc_cis, holdout_frames,
                                     holdout_roc)

B0_RUN = "260817154325-tpu-b0-alpha_mix0.1-0.05-0.01_grayscale_" \
    "crossentropy_lr_2e-05_dr_0.2"
ALPHAS = (0.1, 0.01)
TOL = {"KB": (1e-4, 1e-6), "OLS": (0.0, 2e-4), "B0fold": (0.0, 1e-4)}


def _case(kind: str):
    """(y_hat, y) of one detector group: seeded scores for 12 covers and
    20 stego; with ties; a perfect separator; one where every cover scores
    0 (the FPR never moves, the rank AUC); one class only."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    y = np.r_[np.zeros(12), np.full(20, 0.05)]
    y_hat = np.clip(np.r_[rng.normal(0.03, 0.04, 12),
                          rng.normal(0.08, 0.05, 20)], 0, None)
    if kind == "ties":
        y_hat = np.round(y_hat, 2)
    elif kind == "separable":
        y_hat = np.r_[np.zeros(12), np.linspace(0.3, 0.6, 20)]
    elif kind == "fpr-still":
        y_hat = np.r_[np.zeros(12), rng.uniform(0, 0.01, 20)]
        y_hat[12:15] = 0.0
    elif kind == "one-class":
        y = np.full(32, 0.05)
    return y_hat, y


@pytest.mark.parametrize("kind", ["random", "ties", "separable",
                                  "fpr-still", "one-class"])
@pytest.mark.parametrize("n_boot, seed, level", [
    (2000, None, 0.95), (333, 7, 0.9)])
def test_bootstrap_auc_pe_is_bitwise_jax(kind, n_boot, seed, level):
    y_hat, y = _case(kind)
    kw = dict(n_boot=n_boot, level=level)
    if seed is not None:
        kw["seed"] = seed
    got = bootstrap_auc_pe(y_hat, y, **kw)
    want = jax_ci.bootstrap_auc_pe(y_hat, y, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert type(got[k]) is type(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if kind == "separable":
        assert got["auc_lo"] == got["auc_hi"] == 1.0


def test_bootstrap_roc_cis_is_bitwise_jax():
    """A sweep frame with WS detectors (beta_hat, label alpha / 2) and a
    B0 (score, label alpha), two stego methods."""
    rng = np.random.default_rng(0)
    frames = []
    for model in ("KB", "OLS", "B0_mix0.1-0.05-0.01"):
        for method, alpha in (("Cover", 0.0), ("LSBR", 0.1),
                              ("LSBR", 0.01), ("HILLR", 0.1)):
            n = 10
            vals = rng.uniform(0, 0.2, n) + (alpha if method != "Cover"
                                             else 0)
            col = "score" if "B0" in model else "beta_hat"
            frames.append(pd.DataFrame({"model_name": model,
                                        "stego_method": method,
                                        "alpha": alpha, col: vals}))
    df = pd.concat(frames, ignore_index=True)
    got = bootstrap_roc_cis(df, n_boot=500)
    want = jax_ci.bootstrap_roc_cis(df, n_boot=500)
    pd.testing.assert_frame_equal(frame(got), want, check_exact=True)
    assert got.to_csv() == want.to_csv(index=False)
    assert len(got) == 6


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    """32 p128 covers (split_va's 16 and 16 more of split_tr) with LSBr
    stego at 0.1 and 0.01, and the fold splits: eval = the fold's covers
    and their stego rows, train = the other covers."""
    root = make_catalog(tmp_path_factory.mktemp("p128"), n=32, alphas=ALPHAS)
    va = set(pd.read_csv(P128 / "split_va.csv")["name"])
    tr = set(pd.read_csv(P128 / "split_tr.csv")["name"])
    rows = pd.concat([pd.read_csv(f) for f in sorted(root.glob(
        "*/files.csv"))], ignore_index=True)
    cover_of = "images/" + rows["name"].str.split("/").str[-1]
    folds = {"fold0": va, "fold1": tr - va}
    for tag, members in folds.items():
        rows[cover_of.isin(members)].to_csv(root / f"eval_{tag}.csv",
                                            index=False)
        train = rows[rows["stego_method"].isna() & ~cover_of.isin(members)]
        train.to_csv(root / f"train_{tag}.csv", index=False)
    return root


def _folds(cls, root, b0_dir):
    return [cls(eval_split=f"eval_{tag}.csv", train_split=f"train_{tag}.csv",
                b0s={"B0fold": {"model_dir": b0_dir, "stego_method": "LSBR",
                                "model_name": B0_RUN,
                                "lsbr_reference": False}})
            for tag in ("fold0", "fold1")]


KW = dict(filter_models=("KB", "OLS"), stego_methods=("LSBR",),
          alphas=ALPHAS, batch_size=8)


@pytest.fixture(scope="module")
def frames(cat):
    got = holdout_frames(cat, _folds(Fold, cat, REPO / "weights" / "b0"),
                         device="cpu", **KW)
    want = jax_holdout_frames(cat, _folds(JaxFold, cat,
                                          REPO / "models" / "b0"), **KW)
    return got, want


def test_holdout_frames_match_jax(frames):
    got, want = frame(frames[0]), frames[1]
    assert list(got.columns) == list(want.columns)
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    assert len(got) == len(want) == 3 * 96
    for col in got.columns:
        if col in ("beta_hat", "score", "output"):
            for model, (rtol, atol) in TOL.items():
                sel = (want["model_name"] == model).to_numpy()
                np.testing.assert_allclose(got[col][sel], want[col][sel],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{col} {model}")
        elif col == "prediction":
            clear = (want["output"] - 0.5).abs() > 1e-4
            assert (got[col][clear] == want[col][clear]).all()
        else:
            assert got[col].astype(str).tolist() == \
                want[col].astype(str).tolist(), col
    # every pooled fold score is of a cover outside that fold's fit
    assert set(got.loc[got["model_name"] == "OLS", "fold"]) == \
        {"fold0", "fold1"}
    assert (got.loc[got["model_name"] == "KB", "fold"] == "all").all()


@pytest.fixture(scope="module")
def roc_outputs(cat, frames, tmp_path_factory):
    """Both packages' ``holdout_roc`` on the port's frames (each one's
    ``holdout_frames``, held to JAX's above, patched to return them and
    to record what it was asked for), so that the tables compare the
    arithmetic bit for bit; scores that differ within tolerance may order
    a near-tie the other way (below)."""
    import wsunet_tpu.detect.holdout as jax_holdout
    import wsunet_tpu_torch.detect.holdout as port_holdout

    out, calls = {}, []

    def recorded(scores):
        def holdout_frames(data_path, folds, **kw):
            calls.append((data_path, [f.eval_split for f in folds], kw))
            return scores.copy()
        return holdout_frames

    for pkg, fn, module, cls, b0_dir, extra, scores in (
            ("torch", holdout_roc, port_holdout, Fold,
             REPO / "weights" / "b0", {"device": "cpu"}, frames[0]),
            ("jax", jax_holdout_roc, jax_holdout, JaxFold,
             REPO / "models" / "b0", {}, frame(frames[0]))):
        res = tmp_path_factory.mktemp(pkg)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "holdout_frames", recorded(scores))
            out[pkg] = (fn(cat, _folds(cls, cat, b0_dir), results_dir=res,
                           suffix="t", **KW, **extra), res / "detection")
    assert calls[0] == (cat, ["eval_fold0.csv", "eval_fold1.csv"],
                        {**KW, "device": "cpu"})
    return out


@pytest.mark.parametrize("name", ["auc_0.01_t.csv", "auc_0.01_t_ci.csv",
                                  "auc_by_alpha_t.csv", "roc_0.01_t.csv",
                                  "scores_t.csv"])
def test_holdout_roc_tables_equal_jax(roc_outputs, name):
    got = pd.read_csv(roc_outputs["torch"][1] / name)
    want = pd.read_csv(roc_outputs["jax"][1] / name)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (roc_outputs["torch"][1] / name).read_bytes() == \
        (roc_outputs["jax"][1] / name).read_bytes()


def test_holdout_roc_returns_the_auc_table(roc_outputs):
    got, want = frame(roc_outputs["torch"][0]), roc_outputs["jax"][0]
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))
    assert got["model_name"].tolist() == ["B0fold", "KB", "OLS"]
    scores = pd.read_csv(roc_outputs["torch"][1] / "scores_t.csv")
    assert list(scores.columns) == ["name", "fold", "model_name",
                                    "stego_method", "alpha", "beta_hat",
                                    "score"]


def test_pooled_roc_within_a_near_tie_of_jax(frames):
    """The pooled tables on each package's own scores.  A cover and its
    stego at alpha 0.01 score within about 1e-5 of each other (B0), and
    OLS's scores differ from JAX's by up to 2e-4 against a grid of 0.002:
    within tolerance a near-tie may order the other way, or a score fall
    on the other side of a threshold.  So: KB equal; B0 and OLS within one
    cover-stego pair's weight (AUC, wAUC: 2 / (32 * 64)) and one image's
    (P_E, P_MD@5%FP: 1 / 32)."""
    from wsunet_tpu.detect import produce_roc as jax_produce_roc
    from wsunet_tpu_torch.detect import produce_roc

    cols = ["model_name", "auc", "p_e", "wauc", "pmd_5fp"]
    got = frame(produce_roc(frames[0]))[cols].drop_duplicates().set_index(
        "model_name")
    want = jax_produce_roc(frames[1])[cols].drop_duplicates().set_index(
        "model_name")
    pd.testing.assert_series_equal(got.loc["KB"], want.loc["KB"])
    bound = {"auc": 2 / (32 * 64), "wauc": 2 / (32 * 64),
             "p_e": 1 / 32, "pmd_5fp": 1 / 32}
    for model in ("B0fold", "OLS"):
        for k, b in bound.items():
            assert abs(got.loc[model, k] - want.loc[model, k]) <= b, \
                (model, k, got.loc[model, k], want.loc[model, k])


_BLOCKED_ROC = LOAD_TABLE + """
import sys
from wsunet_tpu_torch.detect import Fold, holdout
scores = load_table(sys.argv[1])
holdout.holdout_frames = lambda data_path, folds, **kw: scores
holdout.holdout_roc(sys.argv[2], [Fold(eval_split="eval_fold0.csv")],
                    results_dir=sys.argv[3], suffix="t",
                    alphas=(0.1, 0.01))
"""


@pytest.fixture(scope="module")
def blocked_roc(cat, frames, tmp_path_factory):
    """JAX's ``holdout_roc`` on JAX's own frames, and the port's on the
    same frames in a process without the five host packages (the
    columns passed as numpy arrays); both results directories."""
    import wsunet_tpu.detect.holdout as jax_holdout

    tmp = tmp_path_factory.mktemp("blocked_roc")
    save_columns(frames[1], tmp / "scores.npz")
    run_without_host_packages([tmp / "scores.npz", cat, tmp / "port"], tmp,
                              code=_BLOCKED_ROC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_holdout, "holdout_frames",
                   lambda data_path, folds, **kw: frames[1].copy())
        jax_holdout_roc(cat, [JaxFold(eval_split="eval_fold0.csv")],
                        results_dir=tmp / "jax", suffix="t",
                        alphas=(0.1, 0.01))
    return tmp / "port" / "detection", tmp / "jax" / "detection"


@pytest.mark.parametrize("name", ["auc_0.01_t.csv", "auc_0.01_t_ci.csv",
                                  "auc_by_alpha_t.csv", "roc_0.01_t.csv",
                                  "scores_t.csv"])
def test_holdout_files_without_host_packages_are_jax_bytes(blocked_roc,
                                                           name):
    """Where pandas, PIL, cv2, matplotlib and seaborn cannot be imported,
    ``holdout_roc`` on JAX's per-image scores writes JAX's files, byte for
    byte."""
    port, jax = blocked_roc
    assert (port / name).read_bytes() == (jax / name).read_bytes()


def test_holdout_ols_needs_a_train_split(cat):
    with pytest.raises(ValueError, match="train_split"):
        holdout_frames(cat, [Fold(eval_split="eval_fold0.csv")],
                       filter_models=("OLS",), device="cpu")
