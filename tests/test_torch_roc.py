"""Port parity: the numpy ROC curve, AUC and meters
(wsunet_tpu_torch.detect.metrics) against scikit-learn and the JAX
package's meters, and ``roc_stats`` / ``produce_roc``
(wsunet_tpu_torch.detect.roc) against ``wsunet_tpu.detect.produce_roc``.

Every comparison is exact (``assert_array_equal`` / frame equality): both
sides run the same float64 numpy arithmetic on the same scores.  The
port's table has no index, so the JAX frame is compared after
``reset_index(drop=True)``."""

import warnings

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn import metrics as skm

from wsunet_tpu.detect import metrics as jmetrics
from wsunet_tpu.detect import produce_roc as jax_produce_roc
from wsunet_tpu_torch.detect import metrics, produce_roc, roc_stats

from torch_p128 import REPO, frame

GOLDEN = REPO / "weights" / "golden" / "p128_lsbr.npz"


def _scores_with_ties():
    """Labels and scores drawn from a small grid, so ties are common."""
    return st.integers(2, 40).flatmap(lambda n: st.tuples(
        st.lists(st.integers(0, 1), min_size=n, max_size=n),
        st.lists(st.integers(0, 6), min_size=n, max_size=n)))


@settings(max_examples=200, deadline=None, database=None)
@given(_scores_with_ties(), st.booleans(), st.sampled_from([1.0, 7.0, 0.25]))
def test_roc_curve_is_sklearns(data, drop, scale):
    y, s = np.asarray(data[0]), np.asarray(data[1]) / scale
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # one-class draws: NaN rates
        want = skm.roc_curve(y, s, pos_label=1, drop_intermediate=drop)
    got = metrics.roc_curve(y, s, pos_label=1, drop_intermediate=drop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0] == np.inf
    fpr, tpr = got[0], got[1]
    if not (np.isnan(fpr).any() or np.isnan(tpr).any()):
        assert metrics.auc(fpr, tpr) == skm.auc(fpr, tpr)
        assert metrics.roc_auc_score(y, s) == skm.roc_auc_score(y, s)


@settings(max_examples=200, deadline=None, database=None)
@given(_scores_with_ties())
def test_meters_match_jax(data):
    y, s = np.asarray(data[0]), np.asarray(data[1]) / 6.0
    if len(np.unique(y)) < 2:
        return
    for name in ("PEMeter", "PMD5FPMeter", "AUCMeter", "wAUCMeter"):
        got, want = getattr(metrics, name)(), getattr(jmetrics, name)()
        got.update(y, s)
        want.update(y, s)
        np.testing.assert_array_equal(got.avg, want.avg)
        assert got.name == want.name


def test_auc_rejects_unordered_x_and_one_point():
    with pytest.raises(ValueError):
        metrics.auc([0, 1, 0.5], [0, 1, 1])
    with pytest.raises(ValueError):
        metrics.auc([0], [1])
    assert metrics.auc([1, 0.5, 0], [1, 1, 0]) == skm.auc([1, 0.5, 0],
                                                        [1, 1, 0])
    with pytest.raises(ValueError):
        metrics.roc_auc_score([1, 1, 1], [0.1, 0.2, 0.3])


def _sweep_frame(rng, n, clip_covers=False):
    """Rows as the roc command builds them: covers (alpha 0) and LSBR
    stego at two rates, for three detectors."""
    frames = []
    for model in ("KB", "KB-w", "UNet"):
        for method, alpha in (("Cover", 0.0), ("LSBR", 0.1), ("LSBR", 0.01)):
            beta = rng.normal(alpha / 2, 0.03, n)
            if clip_covers and method == "Cover":
                beta = -np.abs(beta)    # every cover clips to 0
            frames.append(pd.DataFrame({
                "name": [f"{i}.png" for i in range(n)],
                "stego_method": method, "alpha": alpha,
                "beta_hat": beta, "model_name": model}))
    return pd.concat(frames).reset_index(drop=True)


@pytest.mark.parametrize("clip_covers", [False, True])
def test_produce_roc_matches_jax(clip_covers):
    """clip_covers: every cover's clipped score is 0, so the FPR never
    moves and both sides take the tie-aware rank AUC."""
    df = _sweep_frame(np.random.default_rng(3), 40, clip_covers)
    got = frame(produce_roc(df))
    want = jax_produce_roc(df).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    if clip_covers:
        assert got["auc"].notna().all() and (got["fpr"] == 0).all()


def test_roc_stats_single_class_is_nan():
    y_hat = np.linspace(0, 0.2, 10)
    stats = roc_stats(y_hat, np.full(10, 0.05))
    assert np.isnan(stats["auc"]) and np.isnan(stats["wauc"])
    df = pd.DataFrame({"stego_method": "LSBR", "alpha": 0.1,
                       "beta_hat": y_hat, "model_name": "KB"})
    pd.testing.assert_frame_equal(frame(produce_roc(df)),
                                  jax_produce_roc(df).reset_index(drop=True))


def test_roc_stats_on_golden_scores_equals_the_golden_summary():
    """The golden file's ROC summary was made by the JAX package's
    produce_roc from the golden scores; roc_stats on those scores gives
    the same numbers."""
    gold = np.load(GOLDEN)
    sets = list(gold["sets"])
    for a, alpha in enumerate(gold["alphas"]):
        y = np.r_[np.zeros(64), np.full(64, alpha / 2)]
        for d, det in enumerate(gold["detectors"]):
            beta = gold[f"beta/{det}"].astype("float64")
            scores = np.clip(np.r_[beta[0], beta[sets.index(str(alpha))]],
                             0, None)
            stats = roc_stats(scores, y)
            got = [stats[k] for k in gold["stats"]]
            np.testing.assert_array_equal(got, gold["roc"][a, d])
