"""Preprocessing defenses and the feature-statistics detector."""

from .detector import (calibrate_feature_threshold, feature_score,
                       make_features_fn, score_from_features,
                       threshold_from_scores)
from .preprocess import (DefenseConfig, defend_input, defense_quantization,
                         defense_smoothing)

__all__ = ["DefenseConfig", "calibrate_feature_threshold", "defend_input",
           "defense_quantization", "defense_smoothing", "feature_score",
           "make_features_fn", "score_from_features", "threshold_from_scores"]
