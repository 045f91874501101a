"""FAB-T: the targeted Fast Adaptive Boundary attack (Croce & Hein, ICML
2020; port of ``attacks/fab.py``).

The minimal-norm arm of AutoAttack: it projects onto the linearized decision
boundary between the true class and a target class, with extrapolation
(``eta``), a bias toward the original point (``alpha_max``) and a backward
step once misclassified (``beta``), and returns the closest misclassified
iterate found.

The box-constrained projection onto a hyperplane is a fixed-count bisection
on the scalar lambda of ``u(lambda) = clip(z - lambda * s * d, 0, 1)``
(``project_box_hyperplane``): elementwise passes and one dot product an
iteration, no data-dependent sort.  The targets are the clean-logit ranks
2..K+1 (AutoAttack-T); each target is one restart from the clean point
jittered inside the eps ball, its steps a Python loop, the best iterate kept
over all restarts.  The L∞ jitter is ``0.5 *`` the Philox noise kernel's
Uniform(-eps, eps) on a CUDA device; the L2 jitter a normal draw scaled onto
the sphere (APGD's ``draw_start``).
"""

from __future__ import annotations

import torch

from .api import LogitsFn
from .apgd import draw_start, runner_up_targets


def project_box_hyperplane(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           n_iters: int = 30, norm: str = "linf") -> torch.Tensor:
    """The min-``norm`` projection of ``z`` onto {u : w.u + b = 0} cut to
    [0,1]^d.  ``z``, ``w``: [B, ...]; ``b``: [B].

    - 'linf': ``u(l) = clip(z - l*s*sign(w))``, the minimizer of ``s*(w.u)``
      over each l-box, so the smallest root of ``g(l) = w.u(l) + b`` is the
      least L∞ distance (l in [0, 1]); ``n_iters`` halvings.
    - 'l2': ``u(l) = clip(z - l*s*w)``, the KKT form of the box-constrained
      least-squares projection; ``l`` is capped at ``1/min|w_i|`` (every
      coordinate saturated beyond it); at least 60 halvings.

    The side test is ``sign(g(u(mid))) == s``: a zero counts as a side.
    Where the constraint cannot be met inside the box the result is the
    closest point reachable.
    """
    if norm not in ("linf", "l2"):
        raise ValueError(f"unknown projection norm '{norm}'")
    axes = tuple(range(1, z.ndim))
    bshape = (slice(None),) + (None,) * (z.ndim - 1)

    def gval(u):
        return torch.sum(w * u, dim=axes) + b

    s_vec = torch.sign(gval(z))  # [B]: the side of the hyperplane z starts on
    if norm == "linf":
        direction = torch.sign(w) * s_vec[bshape]
        hi = torch.ones(z.shape[0], dtype=z.dtype, device=z.device)
    else:
        direction = w * s_vec[bshape]
        absw = torch.abs(w)
        min_nonzero = torch.amin(
            torch.where(absw > 1e-20, absw, torch.inf).reshape(z.shape[0], -1), dim=-1)
        hi = torch.clamp_max(1.0 / torch.clamp_min(min_nonzero, 1e-20), 1e12)

    def u_of(lam):
        return torch.clamp(z - lam[bshape] * direction, 0.0, 1.0)

    lo = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    n = int(n_iters) if norm == "linf" else max(int(n_iters), 60)
    for _ in range(n):
        mid = 0.5 * (lo + hi)
        # still on the starting side at mid: the move must be larger
        over = torch.sign(gval(u_of(mid))) == s_vec
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    return u_of(hi)


def fab_targeted_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                        eps: float, steps: int = 100, n_targets: int = 9,
                        generator: torch.Generator, eta: float = 1.05, beta: float = 0.9,
                        alpha_max: float = 0.1, norm: str = "linf") -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> the closest misclassified iterate found (the
    distance in ``norm``: 'linf' | 'l2').

    ``eps`` sets only the restarts' jitter radius: FAB minimizes the norm
    and may end outside the ball; the caller decides whether such a success
    counts (``run_attack`` returns the clean input for it, as AutoAttack
    does).  Samples no iterate misclassified return the clean input.
    """
    eps = float(eps)
    x_orig = x
    dist_axes = tuple(range(1, x.ndim))

    def expand(v):
        return v[:, None, None, None]

    def dist_of(a, b_):
        if norm == "linf":
            return torch.amax(torch.abs(a - b_), dim=dist_axes)
        return torch.sqrt(torch.sum(torch.square(a - b_), dim=dist_axes))

    with torch.no_grad():
        logits_clean = logits_fn(x)
    n_targets = int(min(n_targets, logits_clean.shape[-1] - 1))
    targets = runner_up_targets(logits_clean, n_targets)

    def margin_and_grad(z, y_t):
        """g = f_y(z) - f_t(z) (adversarial where g < 0) and its gradient."""
        zg = z.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = logits_fn(zg)
            g = (torch.gather(logits, -1, y_true[:, None].long())[:, 0]
                 - torch.gather(logits, -1, y_t[:, None].long())[:, 0])
            (w,) = torch.autograd.grad(torch.sum(g), zg)
        return g.detach(), w

    best_adv = x_orig
    best_dist = torch.full(x.shape[:1], torch.inf, dtype=x.dtype, device=x.device)
    for y_t in targets:
        # the restart: the clean point jittered inside the eps ball of the
        # norm (an L2 jitter on the sphere: a per-pixel uniform one would
        # have an L2 norm of about eps*sqrt(HWC))
        noise = draw_start(x.shape, eps, generator, x.device, norm).to(x.dtype)
        if norm == "l2":
            g_nrm = torch.sqrt(torch.sum(torch.square(noise), dim=dist_axes, keepdim=True))
            noise = eps * noise / (g_nrm + 1e-12)
        x_k = torch.clamp(x_orig + 0.5 * noise, 0.0, 1.0)
        for _ in range(int(steps)):
            g, w = margin_and_grad(x_k, y_t)
            # the hyperplane w.u + b = 0 of the linearization at x_k
            b_lin = g - torch.sum(w * x_k, dim=dist_axes)
            p_k = project_box_hyperplane(x_k, w, b_lin, norm=norm)
            p_o = project_box_hyperplane(x_orig, w, b_lin, norm=norm)
            d_k = dist_of(p_k, x_k)
            d_o = dist_of(p_o, x_orig)
            alpha = torch.clamp(d_k / (d_k + d_o + 1e-12), 0.0, alpha_max)
            x_next = torch.clamp(
                expand(1.0 - alpha) * (x_k + eta * (p_k - x_k))
                + expand(alpha) * (x_orig + eta * (p_o - x_orig)), 0.0, 1.0)

            with torch.no_grad():
                fooled = torch.argmax(logits_fn(x_next), dim=-1) != y_true
            dist = dist_of(x_next, x_orig)
            improved = fooled & (dist < best_dist)
            best_adv = torch.where(expand(improved), x_next, best_adv)
            best_dist = torch.where(improved, dist, best_dist)
            # the backward step: once misclassified, pull toward the original
            x_k = torch.where(expand(fooled), beta * x_next + (1.0 - beta) * x_orig, x_next)
    return best_adv
