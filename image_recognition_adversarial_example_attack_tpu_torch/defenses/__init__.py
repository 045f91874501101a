"""Preprocessing defenses (smoothing, quantization, JPEG, TV) and the
feature-statistics detector."""

from .detector import (calibrate_feature_threshold, feature_score,
                       make_features_fn, score_from_features,
                       threshold_from_scores)
from .jpeg import jpeg_compress_batch, jpeg_roundtrip_host
from .jpeg_dct import jpeg_dct_roundtrip
from .preprocess import (DefenseConfig, defend_input, defense_quantization,
                         defense_smoothing)
from .tv import TV_STEPS, TV_WEIGHT, rof_energy, total_variation, tv_minimize

__all__ = ["DefenseConfig", "TV_STEPS", "TV_WEIGHT", "calibrate_feature_threshold",
           "defend_input", "defense_quantization", "defense_smoothing", "feature_score",
           "jpeg_compress_batch", "jpeg_dct_roundtrip", "jpeg_roundtrip_host",
           "make_features_fn", "rof_energy", "score_from_features",
           "threshold_from_scores", "total_variation", "tv_minimize"]
