"""The attacks behind ``run_attack``, with their threat models in
``ATTACK_THREAT``: the JAX package's 25 names.  White-box: FGSM, PGD in the
L∞, L2 and L1 balls, CW-L2, the transfer family MI-FGSM, DI-FGSM and
TI-FGSM, APGD-CE/DLR/T, FAB-T, DeepFool, EAD, JSMA, stAdv and the spatial
attack.  Black-box: Square (L∞, L2), NES, SPSA, Bandits-TD, SimBA,
HopSkipJump and the Boundary attack.  Also the worst-of-restarts PGD, the
detector-aware FGSM/PGD, the EOT wrapper, and the universal threat models:
the universal perturbation (UAP) and the adversarial patch."""

from .api import (ATTACK_NAMES, ATTACK_THREAT, AttackParams, LogitsFn, cross_entropy_sum,
                  input_grad, make_ensemble_logits_fn, make_logits_fn, predict_labels,
                  run_attack)
from .apgd import (apgd_attack, apgd_ce_attack, apgd_dlr_attack, apgd_targeted_attack,
                   dlr_loss, dlr_loss_targeted)
from .bandits import bandits_attack
from .boundary import boundary_attack
from .cw import CWResult, cw_l2_attack
from .deepfool import deepfool_attack
from .detector_aware import detector_aware_fgsm, detector_aware_pgd
from .dim import dim_attack, diverse_input
from .ead import EADResult, ead_attack
from .eot import gaussian_noise_transform, make_eot_logits_fn, universal_perturbation
from .fab import fab_targeted_attack, project_box_hyperplane
from .fgsm import fgsm_attack
from .grad_est import nes_attack, spsa_attack
from .hsja import hsja_attack
from .jsma import jsma_attack
from .mifgsm import mifgsm_attack
from .patch import PatchResult, apply_patch, patch_attack, patch_success_rate, sample_placements
from .pgd import (pgd_l1_attack, pgd_l2_attack, pgd_linf_attack, pgd_multi_restart, pgd_step,
                  project_l1_ball)
from .simba import dct_basis_image, simba_attack
from .spatial import SpatialResult, affine_warp, spatial_attack
from .square import square_attack, square_l2_attack
from .stadv import StAdvResult, flow_smoothness, flow_warp, stadv_attack
from .tim import tim_attack
from .uap import UAPResult, apply_uap, uap_attack, uap_fooling_rate

__all__ = ["ATTACK_NAMES", "ATTACK_THREAT", "AttackParams", "CWResult", "EADResult",
           "LogitsFn", "PatchResult", "SpatialResult", "StAdvResult", "UAPResult",
           "affine_warp", "apgd_attack", "apgd_ce_attack", "apgd_dlr_attack",
           "apgd_targeted_attack", "apply_patch", "apply_uap", "bandits_attack",
           "boundary_attack", "cross_entropy_sum", "cw_l2_attack", "dct_basis_image",
           "deepfool_attack", "detector_aware_fgsm", "detector_aware_pgd", "dim_attack",
           "diverse_input", "dlr_loss", "dlr_loss_targeted", "ead_attack",
           "fab_targeted_attack", "fgsm_attack", "flow_smoothness", "flow_warp",
           "gaussian_noise_transform", "hsja_attack", "input_grad", "jsma_attack",
           "make_ensemble_logits_fn", "make_eot_logits_fn", "make_logits_fn",
           "mifgsm_attack", "nes_attack", "patch_attack", "patch_success_rate",
           "pgd_l1_attack", "pgd_l2_attack", "pgd_linf_attack",
           "pgd_multi_restart", "pgd_step", "predict_labels", "project_box_hyperplane",
           "project_l1_ball", "run_attack", "sample_placements", "simba_attack",
           "spatial_attack", "spsa_attack", "square_attack", "square_l2_attack",
           "stadv_attack", "tim_attack", "uap_attack", "uap_fooling_rate",
           "universal_perturbation"]
