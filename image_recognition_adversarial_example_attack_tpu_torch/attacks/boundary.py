"""Boundary attack: the original decision-based black-box attack (Brendel,
Rauber & Bethge, ICLR 2018; port of ``attacks/boundary.py``).

Per step and sample:

1. spherical step: a normal draw orthogonalized against the direction to
   the original, then projected back onto the sphere of the current radius
   ``d = ||x - x_adv||`` around it (a walk along the boundary);
2. source step: contract toward the original by a fraction;
3. two hard-label decisions decide acceptance; the step sizes adapt
   multiplicatively (x1.04 on success, x0.96 on failure; the source step
   only on steps whose spherical candidate held).

It keeps each sample's closest (L2) adversarial iterate.  The start is
HopSkipJump's (``hsja.initialize``); the walk's normals are drawn on the
device from a generator seeded once from the caller's (``draw_eta``, the
tests' patch point).
"""

from __future__ import annotations

import torch

from ..core.rng import device_generator, standard_normal
from .api import LogitsFn
from .hsja import _expand, _l2, decision_fn, initialize


def draw_eta(shape, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """One step's normal draw, float32 of ``shape`` on ``device``."""
    return standard_normal(shape, generator, device)


def boundary_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                    steps: int = 500, spherical_step: float = 0.01, source_step: float = 0.01,
                    init_trials: int = 12, generator: torch.Generator,
                    x_init: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1] (untargeted L2).

    ``steps`` walk iterations (2 decision queries each); the step sizes are
    per-sample initial values that adapt.  Samples with no adversarial
    start are returned unchanged."""
    is_adv = decision_fn(logits_fn, y_true)
    g_dev = device_generator(generator, x.device)
    b, dt, axes = x.shape[0], x.dtype, (1, 2, 3)
    with torch.no_grad():
        x_adv, initialized = initialize(is_adv, x, init_trials, g_dev, x_init)
        sph = torch.full((b,), float(spherical_step), dtype=dt, device=x.device)
        src = torch.full((b,), float(source_step), dtype=dt, device=x.device)
        best_adv = x_adv
        best_d = torch.where(initialized, _l2(x_adv - x), torch.inf)
        for _ in range(int(steps)):
            diff = x - x_adv
            safe_d = torch.clamp_min(_l2(diff), 1e-12)
            u = diff / _expand(safe_d)  # unit vector toward the original

            # 1. the spherical candidate: orthogonal jitter, back onto the
            # d-sphere around x
            eta = draw_eta(x.shape, g_dev, x.device).to(dt)
            eta = eta - _expand(torch.sum(eta * u, dim=axes)) * u
            eta_n = torch.clamp_min(_l2(eta), 1e-12)
            cand_s = x_adv + _expand(sph * safe_d / eta_n) * eta
            away = cand_s - x
            cand_s = x + _expand(safe_d / torch.clamp_min(_l2(away), 1e-12)) * away
            cand_s = torch.clamp(cand_s, 0.0, 1.0)
            # 2. the source step toward the original
            cand = torch.clamp(cand_s + _expand(src) * (x - cand_s), 0.0, 1.0)

            # 3. two decisions: the full candidate is taken only if both hold
            ok_s = is_adv(cand_s)
            ok_full = ok_s & is_adv(cand)
            accept = ok_full & initialized
            x_adv = torch.where(_expand(accept), cand, x_adv)

            # 4. toward ~50% acceptance; the source step adapts only where
            # the spherical candidate held
            sph = torch.clamp(torch.where(ok_s, sph * 1.04, sph * 0.96), 1e-5, 1.0)
            src = torch.clamp(torch.where(ok_s, torch.where(ok_full, src * 1.04, src * 0.96),
                                          src * 1.0), 1e-6, 1.0)

            # 5. the closest adversarial iterate
            d_new = _l2(x_adv - x)
            better = accept & (d_new < best_d)
            best_adv = torch.where(_expand(better), x_adv, best_adv)
            best_d = torch.where(better, d_new, best_d)
        out = torch.where(_expand(torch.isfinite(best_d)), best_adv, x_adv)
        return torch.where(_expand(initialized), out, x)
