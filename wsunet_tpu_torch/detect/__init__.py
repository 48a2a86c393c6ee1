from . import metrics
from .b0_eval import get_b0_detector, infer_b0, load_pretrained_b0
from .b0_eval import run as b0_run
from .ci import bootstrap_auc_pe, bootstrap_roc_cis
from .holdout import Fold, holdout_frames, holdout_roc
from .roc import (TAUS, iter_detector_groups, produce_roc, roc_stats,
                  scores_and_labels)

__all__ = ["metrics", "TAUS", "iter_detector_groups", "produce_roc",
           "roc_stats", "scores_and_labels", "bootstrap_auc_pe",
           "bootstrap_roc_cis", "Fold", "holdout_frames", "holdout_roc",
           "infer_b0", "get_b0_detector", "load_pretrained_b0", "b0_run"]
