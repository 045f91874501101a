"""Preprocessing defenses (smoothing, quantization, JPEG, TV) and the
feature-statistics, feature-squeezing and Mahalanobis detectors."""

from .detector import (calibrate_feature_threshold, calibrate_squeezing_threshold,
                       feature_score, is_adversarial_by_feature,
                       is_adversarial_by_squeezing, make_features_fn,
                       score_from_features, squeezing_score, threshold_from_scores)
from .jpeg import jpeg_compress_batch, jpeg_roundtrip_host
from .jpeg_dct import jpeg_dct_roundtrip
from .mahalanobis import (MahalanobisParams, calibrate_mahalanobis, fit_mahalanobis,
                          is_adversarial_by_mahalanobis, mahalanobis_score,
                          mahalanobis_score_from_features, pool_features)
from .preprocess import (DefenseConfig, defend_input, defense_quantization,
                         defense_smoothing)
from .tv import TV_STEPS, TV_WEIGHT, rof_energy, total_variation, tv_minimize

__all__ = ["DefenseConfig", "MahalanobisParams", "TV_STEPS", "TV_WEIGHT",
           "calibrate_feature_threshold", "calibrate_mahalanobis",
           "calibrate_squeezing_threshold", "defend_input", "defense_quantization",
           "defense_smoothing", "feature_score", "fit_mahalanobis",
           "is_adversarial_by_feature", "is_adversarial_by_mahalanobis",
           "is_adversarial_by_squeezing", "jpeg_compress_batch", "jpeg_dct_roundtrip",
           "jpeg_roundtrip_host", "mahalanobis_score", "mahalanobis_score_from_features",
           "make_features_fn", "pool_features", "rof_energy", "score_from_features",
           "squeezing_score", "threshold_from_scores", "total_variation", "tv_minimize"]
