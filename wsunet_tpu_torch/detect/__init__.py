from . import metrics
from .roc import (TAUS, iter_detector_groups, produce_roc, roc_stats,
                  scores_and_labels)

__all__ = ["metrics", "TAUS", "iter_detector_groups", "produce_roc",
           "roc_stats", "scores_and_labels"]
