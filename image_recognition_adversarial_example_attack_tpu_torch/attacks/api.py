"""Attack dispatch and the model-adapter closure (port of ``attacks/api.py``).

Every attack is a function of ``(logits_fn, x01, y, params)`` where
``logits_fn(x01) -> [B, K] float32`` hides the model, its compute dtype and
the ImageNet normalization; ``x01`` is an NHWC float32 batch in [0,1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core.constants import (DEFAULT_ALPHA, DEFAULT_CW_C, DEFAULT_CW_KAPPA, DEFAULT_CW_LR,
                              DEFAULT_EPS, DEFAULT_STEPS)
from ..core.normalize import normalize_batch
from ..core.rng import generator_from_seed
from ..parallel.collective import shard_grad
from ..utils.profiling import span

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def make_logits_fn(model: nn.Module, mean, std,
                   input_dtype: torch.dtype | None = None,
                   method: str | None = None) -> LogitsFn:
    """Builds ``x01 [B,H,W,C] in [0,1] -> logits [B,K] float32``.

    The input is cast to ``input_dtype`` before it is normalized, as the JAX
    package does, so the normalize and the model compute in bfloat16 while
    the attack state stays float32.  The NHWC batch reaches the model as
    ``permute(0, 3, 1, 2)``: on a contiguous NHWC tensor that is a
    channels_last NCHW view, cuDNN's preferred layout.  ``method`` names
    another method of the model (e.g. ``"features_stage3"``) to run instead
    of ``forward``.  Spans: ``model.forward`` around the call,
    ``model.normalize`` and ``model.net`` (the network) inside it.
    """
    def logits_fn(x01: torch.Tensor) -> torch.Tensor:
        with span("model.forward"):
            # the method is looked up at call time, as Flax's ``apply(method=)``
            # does: a family without it fails only where it is used
            fn = model if method is None else getattr(model, method)
            x = x01 if input_dtype is None else x01.to(input_dtype)
            x = normalize_batch(x, mean, std)
            with span("model.net"):
                return fn(x.permute(0, 3, 1, 2)).float()

    return logits_fn


def predict_labels(logits_fn: LogitsFn, x: torch.Tensor) -> torch.Tensor:
    """[B] top-1 labels of ``logits_fn(x)``, with no autograd graph."""
    with span("predict"), torch.no_grad():
        return torch.argmax(logits_fn(x), dim=-1)


def make_ensemble_logits_fn(logits_fns, weights=None) -> LogitsFn:
    """The weighted mean of member logits (the logit-fusion ensemble of Dong
    et al., CVPR 2018): an attack on it attacks every member at once, one
    backward pass through all of them per step.  Equal weights by default;
    given weights are normalized to sum to 1.  Refuses no members, a weight
    count other than the member count, a non-positive weight sum, and
    members whose logits differ in shape."""
    fns = list(logits_fns)
    if not fns:
        raise ValueError("ensemble needs at least one member")
    if weights is None:
        w = [1.0 / len(fns)] * len(fns)
    else:
        w = [float(v) for v in weights]
        if len(w) != len(fns):
            raise ValueError(f"{len(w)} weights for {len(fns)} members")
        total = sum(w)
        if total <= 0:
            raise ValueError("ensemble weights must sum to a positive value")
        w = [v / total for v in w]

    def ensemble(x: torch.Tensor) -> torch.Tensor:
        outs = [fn(x) for fn in fns]
        shapes = {tuple(o.shape) for o in outs}
        if len(shapes) != 1:
            raise ValueError("ensemble members disagree on logits shape "
                             f"{sorted(shapes)} — members must share one class space")
        out = w[0] * outs[0]
        for wi, o in zip(w[1:], outs[1:]):
            out = out + wi * o
        return out

    return ensemble


def per_sample_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy of each sample, [B]."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y[:, None].long())[:, 0]


def cross_entropy_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy SUMMED over the batch (not averaged): the 1/B
    factor is invariant under sign() and keeps per-sample gradients apart."""
    return per_sample_ce(logits, y).sum()


def success_history(hist: list, x: torch.Tensor) -> torch.Tensor:
    """The query attacks' per-step masks stacked into [steps, B] bool
    ([0, B] for no step)."""
    if not hist:
        return torch.zeros((0, x.shape[0]), dtype=torch.bool, device=x.device)
    return torch.stack(hist)


def input_grad(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d(CE)/dx only. With the model's parameters frozen, autograd records
    only the input-gradient chain.  In a shard of a coupled sharded step
    (``parallel/collective.py``) it is the gradient of every shard's CE."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy_sum(logits_fn(xg), y)
        (grad,) = shard_grad(loss, [xg])
    return grad


@dataclass(frozen=True)
class AttackParams:
    """Every parameter ``run_attack`` plumbs, with the JAX dataclass's names,
    defaults and order (``attacks/api.py::AttackParams``), so that a CLI's
    ``extended_attack_kwargs`` passes whole."""

    eps: float = DEFAULT_EPS
    alpha: float = DEFAULT_ALPHA
    steps: int = DEFAULT_STEPS
    cw_c: float = DEFAULT_CW_C
    cw_kappa: float = DEFAULT_CW_KAPPA
    cw_steps: int = 100
    cw_lr: float = DEFAULT_CW_LR
    random_start: bool = True
    mu: float = 1.0  # the momentum decay of mifgsm, dim and tim
    # square is query-based: its budget is queries, not gradient steps
    square_steps: int = 1000
    deepfool_steps: int = 50
    deepfool_classes: int = 10
    deepfool_overshoot: float = 0.02
    # nes / spsa probe pairs per step
    est_samples: int = 32
    nes_sigma: float = 1e-3
    spsa_delta: float = 1e-2
    # bandits-TD: 2 queries a step; the prior lattice is H/f x W/f
    bandits_steps: int = 500
    bandits_prior_factor: int = 8
    bandits_fd_eta: float = 0.1
    bandits_delta: float = 0.1
    bandits_prior_lr: float = 1.0
    hsja_steps: int = 10
    hsja_probes: int = 32
    # EAD's own c and lr: its raw-gradient FISTA steps need lr*c*|grad| to
    # clear the beta threshold (attacks/ead.py); CW's Adam does not
    ead_beta: float = 1e-3
    ead_c: float = 50.0
    ead_lr: float = 0.05
    # apgd_t / fab restarts: the top-K runner-up classes of the clean logits
    n_target_classes: int = 9
    # stAdv's flow field (non-Lp: tau, not eps, bounds the distortion)
    stadv_steps: int = 200
    stadv_lr: float = 0.01
    stadv_tau: float = 0.05
    boundary_steps: int = 500
    boundary_spherical_step: float = 0.01
    boundary_source_step: float = 0.01
    simba_steps: int = 1000
    simba_eps: float = 0.2
    simba_mode: str = "dct"
    # jsma's L0 budget (features changed, one a step) and per-feature move
    jsma_steps: int = 100
    jsma_theta: float = 1.0
    # pgd_l1 (SLIDE): the top-|grad| fraction of coordinates a step moves
    l1_sparsity: float = 0.01
    # spatial: worst-of-spatial_candidates random draws union a
    # rot x trans x trans grid; zero either part to drop it
    spatial_max_rot: float = 30.0
    spatial_max_trans: float = 0.1
    spatial_candidates: int = 10
    spatial_grid_rot: int = 0
    spatial_grid_trans: int = 0


# ---------------------------------------------------------------------------
# The registry (the JAX package's ``_register``): every attack registers its
# handler and its threat model, so the registry-driven invariant sweep
# (tests/test_torch_zoo_invariants.py) covers each attack as it lands.
#
# Threat models: "linf" / "l2" / "l1" -- an eps-ball in that norm around x;
# "l0" -- a bounded count of changed coordinates; "none" -- minimal-norm or
# non-Lp attacks, held only to the [0,1] range, shape and determinism.
# ---------------------------------------------------------------------------
_DISPATCH: dict[str, Callable[..., torch.Tensor]] = {}
ATTACK_THREAT: dict[str, str] = {}


def _register(name: str, threat: str):
    if threat not in ("linf", "l2", "l1", "l0", "none"):
        raise ValueError(f"unknown threat model '{threat}'")

    def deco(fn):
        _DISPATCH[name] = fn
        ATTACK_THREAT[name] = threat
        return fn

    return deco


@_register("fgsm", "linf")
def _run_fgsm(logits_fn, x, y_true, params, generator, y_target):
    from .fgsm import fgsm_attack

    return fgsm_attack(logits_fn, x, y_true, eps=params.eps, y_target=y_target)


@_register("mifgsm", "linf")
def _run_mifgsm(logits_fn, x, y_true, params, generator, y_target):
    from .mifgsm import mifgsm_attack

    return mifgsm_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                         steps=params.steps, mu=params.mu, y_target=y_target)


@_register("dim", "linf")
def _run_dim(logits_fn, x, y_true, params, generator, y_target):
    from .dim import dim_attack

    return dim_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                      steps=params.steps, generator=generator, mu=params.mu,
                      y_target=y_target)


@_register("tim", "linf")
def _run_tim(logits_fn, x, y_true, params, generator, y_target):
    from .tim import tim_attack

    return tim_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                      steps=params.steps, mu=params.mu, y_target=y_target)


@_register("apgd", "linf")
def _run_apgd(logits_fn, x, y_true, params, generator, y_target):
    from .apgd import apgd_ce_attack

    if y_target is not None:
        raise ValueError("apgd here is the untargeted CE variant")
    return apgd_ce_attack(logits_fn, x, y_true, eps=params.eps, steps=params.steps,
                          generator=generator)


@_register("apgd_dlr", "linf")
def _run_apgd_dlr(logits_fn, x, y_true, params, generator, y_target):
    from .apgd import apgd_dlr_attack

    if y_target is not None:
        raise ValueError("apgd_dlr is the untargeted DLR variant")
    return apgd_dlr_attack(logits_fn, x, y_true, eps=params.eps, steps=params.steps,
                           generator=generator)


@_register("apgd_t", "linf")
def _run_apgd_t(logits_fn, x, y_true, params, generator, y_target):
    from .apgd import apgd_targeted_attack

    if y_target is not None:
        raise ValueError("apgd_t picks its own top-K targets (n_target_classes)")
    x_adv, _ = apgd_targeted_attack(logits_fn, x, y_true, eps=params.eps, steps=params.steps,
                                    n_targets=params.n_target_classes, generator=generator)
    return x_adv


@_register("fab", "linf")
def _run_fab(logits_fn, x, y_true, params, generator, y_target):
    from .fab import fab_targeted_attack

    if y_target is not None:
        raise ValueError(
            "fab is the targeted-restart minimal-norm variant; it picks "
            "its own top-K targets (n_target_classes)")
    x_fab = fab_targeted_attack(logits_fn, x, y_true, eps=params.eps, steps=params.steps,
                                n_targets=params.n_target_classes, generator=generator)
    # FAB minimizes the norm, so its best iterate may lie outside the eps
    # ball; as in AutoAttack such a result does not count: those samples
    # return the clean input
    in_ball = torch.amax(torch.abs(x_fab - x), dim=(1, 2, 3)) <= params.eps + 1e-6
    return torch.where(in_ball[:, None, None, None], x_fab, x)


def _run_square_family(logits_fn, x, y_true, params, generator, y_target, *, l2):
    from .square import square_attack, square_l2_attack

    if y_target is not None:
        raise ValueError("square is the untargeted margin-loss variant")
    fn = square_l2_attack if l2 else square_attack
    return fn(logits_fn, x, y_true, eps=params.eps, steps=params.square_steps,
              generator=generator)


_register("square", "linf")(lambda *a: _run_square_family(*a, l2=False))
_register("square_l2", "l2")(lambda *a: _run_square_family(*a, l2=True))


@_register("deepfool", "none")
def _run_deepfool(logits_fn, x, y_true, params, generator, y_target):
    from .deepfool import deepfool_attack

    if y_target is not None:
        raise ValueError("deepfool flips the model's own prediction; untargeted-only")
    return deepfool_attack(logits_fn, x, y_true, steps=params.deepfool_steps,
                           num_classes=params.deepfool_classes,
                           overshoot=params.deepfool_overshoot)


@_register("bandits", "linf")
def _run_bandits(logits_fn, x, y_true, params, generator, y_target):
    from .bandits import bandits_attack

    return bandits_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                          steps=params.bandits_steps, generator=generator,
                          prior_factor=params.bandits_prior_factor,
                          fd_eta=params.bandits_fd_eta, delta=params.bandits_delta,
                          prior_lr=params.bandits_prior_lr, y_target=y_target)


@_register("nes", "linf")
def _run_nes(logits_fn, x, y_true, params, generator, y_target):
    from .grad_est import nes_attack

    return nes_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                      steps=params.steps, generator=generator, n_samples=params.est_samples,
                      sigma=params.nes_sigma, y_target=y_target)


@_register("spsa", "linf")
def _run_spsa(logits_fn, x, y_true, params, generator, y_target):
    from .grad_est import spsa_attack

    return spsa_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                       steps=params.steps, generator=generator, n_samples=params.est_samples,
                       delta=params.spsa_delta, y_target=y_target)


@_register("hsja", "none")
def _run_hsja(logits_fn, x, y_true, params, generator, y_target):
    from .hsja import hsja_attack

    if y_target is not None:
        raise ValueError("hsja here is the untargeted decision-based variant")
    return hsja_attack(logits_fn, x, y_true, steps=params.hsja_steps,
                       n_probes=params.hsja_probes, generator=generator)


@_register("pgd_l1", "l1")
def _run_pgd_l1(logits_fn, x, y_true, params, generator, y_target):
    from .pgd import pgd_l1_attack

    return pgd_l1_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                         steps=params.steps, generator=generator, sparsity=params.l1_sparsity,
                         random_start=params.random_start, y_target=y_target)


@_register("pgd", "linf")
def _run_pgd(logits_fn, x, y_true, params, generator, y_target):
    from .pgd import pgd_linf_attack

    return pgd_linf_attack(
        logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
        steps=params.steps, generator=generator,
        random_start=params.random_start, y_target=y_target)


@_register("pgd_l2", "l2")
def _run_pgd_l2(logits_fn, x, y_true, params, generator, y_target):
    from .pgd import pgd_l2_attack

    return pgd_l2_attack(logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
                         steps=params.steps, generator=generator,
                         random_start=params.random_start, y_target=y_target)


@_register("ead", "none")
def _run_ead(logits_fn, x, y_true, params, generator, y_target):
    from .ead import ead_attack

    res = ead_attack(logits_fn, x, y_true, c=params.ead_c, kappa=params.cw_kappa,
                     beta=params.ead_beta, steps=params.cw_steps, lr=params.ead_lr,
                     targeted=y_target is not None, y_target=y_target)
    return res.x_adv


@_register("boundary", "none")
def _run_boundary(logits_fn, x, y_true, params, generator, y_target):
    from .boundary import boundary_attack

    if y_target is not None:
        raise ValueError("boundary here is the untargeted walk")
    return boundary_attack(logits_fn, x, y_true, steps=params.boundary_steps,
                           spherical_step=params.boundary_spherical_step,
                           source_step=params.boundary_source_step, generator=generator)


@_register("simba", "none")
def _run_simba(logits_fn, x, y_true, params, generator, y_target):
    from .simba import simba_attack

    if y_target is not None:
        raise ValueError("simba descends the true-class probability; untargeted-only")
    return simba_attack(logits_fn, x, y_true, steps=params.simba_steps, eps=params.simba_eps,
                        mode=params.simba_mode, generator=generator)


@_register("jsma", "l0")
def _run_jsma(logits_fn, x, y_true, params, generator, y_target):
    from .jsma import jsma_attack

    return jsma_attack(logits_fn, x, y_true, steps=params.jsma_steps, theta=params.jsma_theta,
                       y_target=y_target)


@_register("spatial", "none")
def _run_spatial(logits_fn, x, y_true, params, generator, y_target):
    from .spatial import spatial_attack

    if y_target is not None:
        raise ValueError("spatial is the untargeted worst-of-k search")
    res = spatial_attack(logits_fn, x, y_true, max_rot=params.spatial_max_rot,
                         max_trans=params.spatial_max_trans,
                         candidates=params.spatial_candidates,
                         grid_rot=params.spatial_grid_rot,
                         grid_trans=params.spatial_grid_trans, generator=generator)
    return res.x_adv


@_register("stadv", "none")
def _run_stadv(logits_fn, x, y_true, params, generator, y_target):
    from .stadv import stadv_attack

    res = stadv_attack(logits_fn, x, y_true, steps=params.stadv_steps, lr=params.stadv_lr,
                       tau=params.stadv_tau, kappa=params.cw_kappa, y_target=y_target)
    return res.x_adv


@_register("cw", "none")
def _run_cw(logits_fn, x, y_true, params, generator, y_target):
    from .cw import cw_l2_attack

    res = cw_l2_attack(
        logits_fn, x, y_true, c=params.cw_c, kappa=params.cw_kappa,
        steps=params.cw_steps, lr=params.cw_lr, targeted=y_target is not None,
        y_target=y_target)
    return res.x_adv


ATTACK_NAMES: tuple[str, ...] = tuple(_DISPATCH)


def run_attack(attack_name: str, logits_fn: LogitsFn, x: torch.Tensor,
               y_true: torch.Tensor, params: AttackParams,
               generator: torch.Generator | None = None,
               y_target: torch.Tensor | None = None) -> torch.Tensor:
    """A registered name (``ATTACK_NAMES``, the JAX package's 25) -> x_adv in
    [0,1].

    White-box: 'fgsm', 'pgd', 'pgd_l2', 'pgd_l1' (SLIDE, ``l1_sparsity``),
    'cw', the transfer family 'mifgsm' / 'dim' / 'tim', 'apgd' / 'apgd_dlr'
    (Auto-PGD on CE / DLR), 'apgd_t' (targeted-DLR restarts over the top
    ``n_target_classes`` runner-ups), 'fab' (minimal-norm FAB-T; its
    out-of-ball samples return the clean input), 'deepfool' (flips the
    model's own prediction), 'ead' (elastic-net: ``cw_steps``/``cw_kappa``
    with its own ``ead_c``, ``ead_lr``, ``ead_beta``), 'jsma' (L0 saliency,
    ``jsma_steps``/``jsma_theta``), 'spatial' (worst-case rotation and
    translation), 'stadv' (a smooth flow field, ``stadv_*``).

    Black-box, through the forward pass only: 'square' / 'square_l2' (random
    search, ``square_steps`` queries), 'nes' / 'spsa' (gradient estimation,
    ``est_samples`` probe pairs a step), 'bandits' (time and data priors,
    ``bandits_*``), 'simba' (coordinate descent on p_y, ``simba_*``), and the
    decision-based 'hsja' (``hsja_steps``, ``hsja_probes``) and 'boundary'
    (``boundary_*``).  eps does not apply to deepfool, ead, jsma, spatial,
    stadv, cw, boundary, simba or hsja.

    ``y_target`` selects the targeted mode of fgsm, pgd, pgd_l1, pgd_l2, cw,
    ead, jsma, stadv, nes, spsa, bandits and the transfer family; apgd,
    apgd_dlr, apgd_t, fab, deepfool, spatial, square, square_l2, hsja,
    boundary and simba are untargeted-only and raise ValueError on one.
    ``generator`` feeds the randomness (default: seed 0)."""
    handler = _DISPATCH.get(attack_name)
    if handler is None:
        raise ValueError(f"unknown attack '{attack_name}'")
    if generator is None:
        generator = generator_from_seed(0)
    with span("attack"):
        return handler(logits_fn, x, y_true, params, generator, y_target)
