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
    of ``forward``.
    """
    def logits_fn(x01: torch.Tensor) -> torch.Tensor:
        # the method is looked up at call time, as Flax's ``apply(method=)``
        # does: a family without it fails only where it is used
        fn = model if method is None else getattr(model, method)
        x = x01 if input_dtype is None else x01.to(input_dtype)
        x = normalize_batch(x, mean, std)
        return fn(x.permute(0, 3, 1, 2)).float()

    return logits_fn


def predict_labels(logits_fn: LogitsFn, x: torch.Tensor) -> torch.Tensor:
    """[B] top-1 labels of ``logits_fn(x)``, with no autograd graph."""
    with torch.no_grad():
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


def cross_entropy_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy SUMMED over the batch (not averaged): the 1/B
    factor is invariant under sign() and keeps per-sample gradients apart."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y[:, None].long())[:, 0].sum()


def input_grad(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d(CE)/dx only. With the model's parameters frozen, autograd records
    only the input-gradient chain."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy_sum(logits_fn(xg), y)
        (grad,) = torch.autograd.grad(loss, xg)
    return grad


@dataclass(frozen=True)
class AttackParams:
    """The parameters that the ported attacks read (fgsm, pgd, cw and the
    transfer family mifgsm, dim, tim)."""

    eps: float = DEFAULT_EPS
    alpha: float = DEFAULT_ALPHA
    steps: int = DEFAULT_STEPS
    cw_c: float = DEFAULT_CW_C
    cw_kappa: float = DEFAULT_CW_KAPPA
    cw_steps: int = 100
    cw_lr: float = DEFAULT_CW_LR
    random_start: bool = True
    mu: float = 1.0  # the momentum decay of mifgsm, dim and tim


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


@_register("pgd", "linf")
def _run_pgd(logits_fn, x, y_true, params, generator, y_target):
    from .pgd import pgd_linf_attack

    return pgd_linf_attack(
        logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
        steps=params.steps, generator=generator,
        random_start=params.random_start, y_target=y_target)


@_register("cw", "none")
def _run_cw(logits_fn, x, y_true, params, generator, y_target):
    from .cw import cw_l2_attack

    res = cw_l2_attack(
        logits_fn, x, y_true, c=params.cw_c, kappa=params.cw_kappa,
        steps=params.cw_steps, lr=params.cw_lr, targeted=y_target is not None,
        y_target=y_target)
    return res.x_adv


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


ATTACK_NAMES: tuple[str, ...] = tuple(_DISPATCH)


def run_attack(attack_name: str, logits_fn: LogitsFn, x: torch.Tensor,
               y_true: torch.Tensor, params: AttackParams,
               generator: torch.Generator | None = None,
               y_target: torch.Tensor | None = None) -> torch.Tensor:
    """'fgsm' | 'pgd' | 'cw' | 'mifgsm' | 'dim' | 'tim' -> x_adv in [0,1].
    ``y_target`` selects the targeted mode. ``generator`` feeds the
    randomness (pgd's random start, dim's transforms; default: seed 0)."""
    handler = _DISPATCH.get(attack_name)
    if handler is None:
        raise ValueError(f"attack '{attack_name}' is not ported yet "
                         f"(ported: {', '.join(ATTACK_NAMES)})")
    if generator is None:
        generator = generator_from_seed(0)
    return handler(logits_fn, x, y_true, params, generator, y_target)
