"""Gradient-estimation black-box attacks: NES (Ilyas et al., ICML 2018) and
SPSA (Uesato et al., ICML 2018); port of ``attacks/grad_est.py``.

The CE-loss gradient is estimated from antithetic probe pairs,

    g_hat = 1/(2 n c) * sum_i [L(x + c v_i) - L(x - c v_i)] * v_i,

v_i ~ N(0, I) for NES and Rademacher ±1 for SPSA, and the iterate takes
PGD's signed step with the L∞ projection.  Each probe pair is one [2B]
forward; the n probes and the steps are Python loops.  The step
``clip(clip(x + alpha*sign(g), x0 ± eps), 0, 1)`` is the pgd_step wrapper
(``kernels/elementwise.py``): one kernel launch a step on a CUDA device, a
negative alpha in the targeted mode.

The full-size probes are drawn on the device from a generator seeded once
from the caller's (``draw_probe``, the tests' patch point).

bf16 caveat (as in the JAX package): finite differences subtract two
nearly equal losses, so with a bfloat16 model the deltas at the default
radii can sink below the forward's rounding; raise ``sigma``/``delta`` or
run the model in float32 for these attacks.
"""

from __future__ import annotations

import torch

from ..core.rng import device_generator, rademacher, standard_normal
from ..kernels import elementwise
from .api import LogitsFn, per_sample_ce, success_history


def draw_probe(shape, sampler: str, generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    """One probe direction, float32 of ``shape`` on ``device``: a standard
    normal ('gaussian') or ±1 ('rademacher')."""
    if sampler == "gaussian":
        return standard_normal(shape, generator, device)
    return rademacher(shape, generator, device)


def _estimated_grad(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor,
                    generator: torch.Generator, *, n_samples: int, c: float,
                    sampler: str) -> torch.Tensor:
    """The antithetic finite-difference estimate (NES or SPSA probes)."""
    b = x.shape[0]
    y2 = torch.cat([y, y], dim=0)
    g = torch.zeros_like(x)
    for _ in range(int(n_samples)):
        v = draw_probe(x.shape, sampler, generator, x.device).to(x.dtype)
        losses = per_sample_ce(logits_fn(torch.cat([x + c * v, x - c * v], dim=0)), y2)
        g = g + (losses[:b] - losses[b:])[:, None, None, None] * v
    return g / (2.0 * c * n_samples)


def _grad_est_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                     eps: float, alpha: float, steps: int, generator: torch.Generator,
                     n_samples: int, c: float, sampler: str,
                     y_target: torch.Tensor | None, return_history: bool = False):
    x_orig = x.contiguous()
    y_grad = y_true if y_target is None else y_target
    step = float(alpha) if y_target is None else -float(alpha)
    g_dev = device_generator(generator, x.device)
    x_adv, hist = x_orig, []
    with torch.no_grad():
        for _ in range(int(steps)):
            g = _estimated_grad(logits_fn, x_adv, y_grad, g_dev, n_samples=n_samples,
                                c=float(c), sampler=sampler)
            x_adv = elementwise.pgd_step(x_adv, g.contiguous(), x_orig, float(eps), step)
            if return_history:
                # one more forward a step, only for the curves (the
                # untargeted success convention)
                hist.append(torch.argmax(logits_fn(x_adv), dim=-1) != y_true)
    if return_history:
        return x_adv, success_history(hist, x)
    return x_adv


def nes_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
               eps: float, alpha: float, steps: int, generator: torch.Generator,
               n_samples: int = 32, sigma: float = 1e-3,
               y_target: torch.Tensor | None = None, return_history: bool = False):
    """NES: ``n_samples`` antithetic Gaussian probe pairs a step (2n
    queries), smoothing radius ``sigma`` in [0,1] pixel units.  With
    ``return_history`` also the per-step success mask [steps, B]."""
    return _grad_est_attack(logits_fn, x, y_true, eps=eps, alpha=alpha, steps=steps,
                            generator=generator, n_samples=n_samples, c=sigma,
                            sampler="gaussian", y_target=y_target,
                            return_history=return_history)


def spsa_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                eps: float, alpha: float, steps: int, generator: torch.Generator,
                n_samples: int = 32, delta: float = 1e-2,
                y_target: torch.Tensor | None = None, return_history: bool = False):
    """SPSA: Rademacher probes of size ``delta`` (with ±1 probes the SPSA
    estimator's elementwise 1/v equals v, so it shares NES's core)."""
    return _grad_est_attack(logits_fn, x, y_true, eps=eps, alpha=alpha, steps=steps,
                            generator=generator, n_samples=n_samples, c=delta,
                            sampler="rademacher", y_target=y_target,
                            return_history=return_history)
