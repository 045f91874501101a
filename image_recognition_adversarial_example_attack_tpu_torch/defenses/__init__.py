"""Preprocessing defenses (smoothing, quantization, JPEG, TV), the
feature-statistics, feature-squeezing and Mahalanobis detectors, the
randomization defense, and certification (randomized smoothing, IBP,
CROWN-IBP)."""

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
from .crown_ibp import (crown_backward_bound, crown_ibp_margin, interval_trace,
                        make_crown_verify_fn)
from .ibp import (interval_propagate, logit_bounds, make_verify_fn, pixel_bounds,
                  spec_forward, verified_margin, worst_case_logits)
from .randomization import random_resize_pad, resize_pad, resize_pad_transform
from .smoothing import ABSTAIN, SmoothedClassifier, SmoothingConfig
from .tv import TV_STEPS, TV_WEIGHT, rof_energy, total_variation, tv_minimize, tv_transform

__all__ = ["ABSTAIN", "DefenseConfig", "MahalanobisParams", "SmoothedClassifier",
           "SmoothingConfig", "TV_STEPS", "TV_WEIGHT", "calibrate_feature_threshold",
           "calibrate_mahalanobis", "calibrate_squeezing_threshold", "crown_backward_bound",
           "crown_ibp_margin", "defend_input", "defense_quantization", "defense_smoothing",
           "feature_score", "fit_mahalanobis", "interval_propagate", "interval_trace",
           "is_adversarial_by_feature", "is_adversarial_by_mahalanobis",
           "is_adversarial_by_squeezing", "jpeg_compress_batch", "jpeg_dct_roundtrip",
           "jpeg_roundtrip_host", "logit_bounds", "mahalanobis_score",
           "mahalanobis_score_from_features", "make_crown_verify_fn", "make_features_fn",
           "make_verify_fn", "pixel_bounds", "pool_features", "random_resize_pad",
           "resize_pad", "resize_pad_transform", "rof_energy", "score_from_features",
           "spec_forward", "squeezing_score", "threshold_from_scores", "total_variation",
           "tv_minimize", "tv_transform", "verified_margin", "worst_case_logits"]
