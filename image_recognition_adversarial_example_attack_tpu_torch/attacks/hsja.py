"""HopSkipJump: decision-based (hard-label) black-box attack (Chen, Jordan &
Wainwright, IEEE S&P 2020; port of ``attacks/hsja.py``).

Sees only the decision ``argmax f(x') != y``.  Per iteration:

1. bisect the segment [x, x_adv] onto the boundary (``bs_steps``);
2. estimate the boundary's normal from ``n_probes`` decisions at
   ``x_b + delta*u_i`` (baseline-subtracted Monte-Carlo);
3. a geometric step search along it: ``d/sqrt(t)``, halved until the
   iterate is adversarial again (``halvings`` trials, masked).

It keeps each sample's closest (L2) adversarial iterate.  Every loop count is
fixed and every per-sample decision a masked ``torch.where``, so nothing in
the loop waits for the card.  The uniform starts and the probe directions
are full-size draws made on the device from a generator seeded once from the
caller's (``draw_init``, ``draw_direction``: the tests' patch points).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..core.rng import device_generator, standard_normal, uniform
from .api import LogitsFn


def _l2(v: torch.Tensor) -> torch.Tensor:
    """Per-sample L2 over the feature axes: [B,H,W,C] -> [B]."""
    return torch.sqrt(torch.sum(torch.square(v), dim=(1, 2, 3)))


def _expand(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def draw_init(shape, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """One start trial's Uniform[0, 1) image batch, float32 on ``device``."""
    return uniform(shape, generator, device)


def draw_direction(shape, generator: torch.Generator,
                   device: torch.device | str) -> torch.Tensor:
    """One probe's normal direction (normalized by the caller), float32."""
    return standard_normal(shape, generator, device)


def decision_fn(logits_fn: LogitsFn, y_true: torch.Tensor) -> Callable:
    """x -> [B] bool: the model's decision differs from ``y_true``."""
    return lambda xq: torch.argmax(logits_fn(xq), dim=-1) != y_true


def initialize(is_adv, x: torch.Tensor, init_trials: int, generator: torch.Generator,
               x_init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(starting point, initialized [B]): ``x_init`` where it is adversarial,
    else the first of ``init_trials`` uniform-noise blends
    ``(1-a)*x + a*u`` (a = 1, 1/2, 1/4, 1/10, cycled) that is; samples
    with neither keep ``x``."""
    if x_init is not None:
        initialized = is_adv(x_init)
        return torch.where(_expand(initialized), x_init, x), initialized
    alphas = ([1.0, 0.5, 0.25, 0.1] * (int(init_trials) // 4 + 1))[:int(init_trials)]
    x_adv = x
    found = torch.zeros(x.shape[:1], dtype=torch.bool, device=x.device)
    for alpha in alphas:
        u = draw_init(x.shape, generator, x.device).to(x.dtype)
        cand = torch.clamp((1.0 - alpha) * x + alpha * u, 0.0, 1.0)
        adv = is_adv(cand)
        x_adv = torch.where(_expand(adv & ~found), cand, x_adv)
        found = found | adv
    return x_adv, found


def hsja_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                steps: int = 10, n_probes: int = 32, bs_steps: int = 10, halvings: int = 10,
                init_trials: int = 12, theta: float = 0.01, generator: torch.Generator,
                x_init: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1] (untargeted L2).

    ``x_init`` warm-starts from known-misclassified points; samples with no
    adversarial start are returned unchanged (a decision-based attack needs
    a misclassified point to walk from)."""
    is_adv = decision_fn(logits_fn, y_true)
    g_dev = device_generator(generator, x.device)
    dt = x.dtype
    b = x.shape[0]

    def binary_search(x_adv):
        """Bisect [x, x_adv], keeping the adversarial endpoint."""
        lo, hi = x, x_adv
        for _ in range(int(bs_steps)):
            mid = 0.5 * (lo + hi)
            adv = _expand(is_adv(mid))
            lo, hi = torch.where(adv, lo, mid), torch.where(adv, mid, hi)
        return hi

    def estimate_normal(x_b, delta):
        """Monte-Carlo boundary normal: sum (phi_i - mean(phi)) u_i."""
        g_sum = torch.zeros_like(x)
        u_sum = torch.zeros_like(x)
        phi_sum = torch.zeros((b,), dtype=dt, device=x.device)
        for _ in range(int(n_probes)):
            v = draw_direction(x.shape, g_dev, x.device).to(dt)
            v = v / _expand(torch.clamp_min(_l2(v), 1e-12))
            cand = torch.clamp(x_b + _expand(delta) * v, 0.0, 1.0)
            phi = 2.0 * is_adv(cand).to(dt) - 1.0  # ±1
            g_sum = g_sum + _expand(phi) * v
            phi_sum = phi_sum + phi
            u_sum = u_sum + v
        g = g_sum - _expand(phi_sum / n_probes) * u_sum
        return g / _expand(torch.clamp_min(_l2(g), 1e-12))

    def step_search(x_b, v, d, t):
        """The largest eps in {d/sqrt(t), d/(2 sqrt t), ...} that stays
        adversarial."""
        eps0 = d / math.sqrt(t)
        chosen = torch.zeros((b,), dtype=dt, device=x.device)
        found = torch.zeros((b,), dtype=torch.bool, device=x.device)
        for i in range(int(halvings)):
            eps = eps0 / (2.0 ** i)
            adv = is_adv(torch.clamp(x_b + _expand(eps) * v, 0.0, 1.0))
            chosen = torch.where(adv & ~found, eps, chosen)
            found = found | adv
        out = torch.clamp(x_b + _expand(chosen) * v, 0.0, 1.0)
        return torch.where(_expand(found), out, x_b)

    with torch.no_grad():
        x_adv, initialized = initialize(is_adv, x, init_trials, g_dev, x_init)
        best = x_adv
        best_d = torch.where(initialized, _l2(x_adv - x), torch.inf)
        for t in range(1, int(steps) + 1):
            x_b = binary_search(x_adv)
            d = _l2(x_b - x)
            delta = theta * torch.clamp_min(d, 1e-6)
            v = estimate_normal(x_b, delta)
            x_new = step_search(x_b, v, d, float(t))
            # never adopt a non-adversarial iterate (the estimate can misfire)
            x_adv = torch.where(_expand(is_adv(x_new)), x_new, x_b)
            # x_adv is adversarial for every initialized sample, so the
            # closest one is tracked without another query
            d_now = _l2(x_adv - x)
            better = d_now < best_d
            best = torch.where(_expand(better), x_adv, best)
            best_d = torch.where(better, d_now, best_d)
        # uninitialized samples return unchanged
        return torch.where(_expand(initialized), best, x)
