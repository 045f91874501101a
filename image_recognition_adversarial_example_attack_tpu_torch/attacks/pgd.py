"""PGD in the L∞, L2 and L1 balls, and worst-of-R-restarts PGD (port of
``attacks/pgd.py``).

- ``pgd_linf_attack``: an optional uniform random start in the eps-ball
  (the span ``attack.start``), then ``steps`` iterations (``attack.step``)
  of ``alpha * sign(grad)`` with projection to ``[x0-eps, x0+eps]`` and a
  clip to [0,1].  On a CUDA device the random start is the Philox noise
  kernel and each update the pgd_step kernel (``kernels/elementwise.py``);
  on the CPU their plain versions run.
- ``pgd_l2_attack``: steps along the L2-normalized gradient, projected onto
  the eps-radius L2 ball; its random start is a normal direction scaled to
  a uniform radius.
- ``pgd_l1_attack``: SLIDE (Tramèr & Boneh, NeurIPS 2019), steps along the
  k-sparse steepest-ascent direction of the L1 geometry, projected onto the
  eps-radius L1 ball (``project_l1_ball``); its random start is the noise
  kernel's Uniform(-1, 1), projected and scaled.
- ``pgd_multi_restart``: R runs of ``pgd_linf_attack``, one after another,
  keeping per sample the restart with the highest CE.

Each JAX ``lax.scan`` is a Python loop of one forward+backward a step.  The
random draws are ``draw_start``, ``draw_l2_start`` and ``draw_l1_start``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.rng import standard_normal, uniform
from ..kernels import elementwise
from ..utils.profiling import span
from .api import LogitsFn, input_grad, per_sample_ce

# The plain update (attacks/pgd.py::pgd_step of the JAX package).
pgd_step = elementwise.pgd_step_plain


def draw_start(shape, eps: float, generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    """Uniform(-eps, eps) float32 of ``shape``: the noise kernel on a CUDA
    device, its plain version on the CPU."""
    return elementwise.uniform_noise(shape, eps, generator, device)


def draw_l2_start(shape, generator: torch.Generator, device: torch.device | str):
    """pgd_l2's start: (a standard normal of ``shape``, a [B,1,1,1] radius
    fraction in [0,1)), float32 on ``device``."""
    normal = standard_normal(shape, generator, device)
    radius = uniform((shape[0], 1, 1, 1), generator, generator.device).to(device)
    return normal, radius


def draw_l1_start(shape, generator: torch.Generator, device: torch.device | str):
    """pgd_l1's start: (Uniform(-1, 1) of ``shape`` from the noise kernel, a
    [B,1,1,1] scale in [0,1)), float32 on ``device``."""
    noise = draw_start(shape, 1.0, generator, device)
    scale = uniform((shape[0], 1, 1, 1), generator, generator.device).to(device)
    return noise, scale


def pgd_linf_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor,
                    *, eps: float, alpha: float, steps: int,
                    generator: torch.Generator, random_start: bool = True,
                    y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1].

    With ``y_target`` each step descends the target class's cross-entropy:
    the kernel gets ``-alpha``, which gives the bits of ``alpha*sign(-g)``
    without a pass that negates the gradient.
    """
    eps, alpha = float(eps), float(alpha)
    x_orig = x.contiguous()
    if random_start:
        with span("attack.start"):
            noise = draw_start(x.shape, eps, generator, x.device).to(x.dtype)
            x_adv = torch.clamp(x_orig + noise, 0.0, 1.0)
    else:
        x_adv = x_orig

    y_grad = y_true if y_target is None else y_target
    step = alpha if y_target is None else -alpha
    for _ in range(int(steps)):
        with span("attack.step"):
            grad = input_grad(logits_fn, x_adv, y_grad).contiguous()
            x_adv = elementwise.pgd_step(x_adv, grad, x_orig, eps, step)
    return x_adv


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(v), dim=(1, 2, 3), keepdim=True))
    return v / torch.clamp_min(norm, eps)


def pgd_l2_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor,
                  *, eps: float, alpha: float, steps: int,
                  generator: torch.Generator, random_start: bool = True,
                  y_target: torch.Tensor | None = None) -> torch.Tensor:
    """PGD in the L2 ball: each step moves ``alpha`` along the L2-normalized
    gradient, then the delta is scaled back into the eps ball and the image
    clipped to [0,1].  No kernel: the normalization and the projection are
    reductions the pgd_step kernel does not do."""
    eps, alpha = float(eps), float(alpha)
    x_orig = x
    if random_start:
        normal, radius = draw_l2_start(x.shape, generator, x.device)
        noise = _l2_normalize(normal.to(x.dtype)) * eps * radius.to(x.dtype)
        x_adv = torch.clamp(x_orig + noise, 0.0, 1.0)
    else:
        x_adv = x_orig

    y_grad = y_true if y_target is None else y_target
    direction = 1.0 if y_target is None else -1.0

    def project(x_new):
        delta = x_new - x_orig
        norm = torch.sqrt(torch.sum(torch.square(delta), dim=(1, 2, 3), keepdim=True))
        scale = torch.clamp_max(eps / torch.clamp_min(norm, 1e-12), 1.0)
        return torch.clamp(x_orig + delta * scale, 0.0, 1.0)

    for _ in range(int(steps)):
        grad = input_grad(logits_fn, x_adv, y_grad)
        x_adv = project(x_adv + alpha * direction * _l2_normalize(grad))
    return x_adv


def project_l1_ball(delta: torch.Tensor, eps: float) -> torch.Tensor:
    """Euclidean projection of each sample's delta onto the L1 ball of radius
    ``eps`` (Duchi et al., ICML 2008): soft-threshold at the theta of the
    sorted-cumsum condition.  [B,...] -> [B,...].  The sort is by value
    only, so ties do not matter."""
    eps = float(eps)
    b = delta.shape[0]
    flat = delta.reshape(b, -1)
    n = flat.shape[1]
    a = torch.abs(flat)
    inside = torch.sum(a, dim=-1) <= eps
    mu = torch.sort(a, dim=-1, descending=True).values
    cum = torch.cumsum(mu, dim=-1)
    ar = torch.arange(1, n + 1, dtype=flat.dtype, device=flat.device)
    rho = torch.sum((mu * ar > cum - eps).to(torch.int32), dim=-1)  # >= 1
    theta = (torch.gather(cum, -1, (rho - 1)[:, None].long())[:, 0] - eps) / rho.to(flat.dtype)
    proj = torch.sign(flat) * torch.clamp_min(a - theta[:, None], 0.0)
    return torch.where(inside[:, None], flat, proj).reshape(delta.shape)


def pgd_l1_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor,
                  *, eps: float, alpha: float, steps: int,
                  generator: torch.Generator, sparsity: float = 0.01,
                  random_start: bool = True,
                  y_target: torch.Tensor | None = None) -> torch.Tensor:
    """PGD in the L1 ball (SLIDE).  Each step moves along ``sign(g)`` on the
    top ``sparsity`` fraction of |g| (at least one coordinate), normalized
    to unit L1 norm so that ``alpha`` is an L1 step, then projects onto the
    eps-radius L1 ball and clips to [0,1].  L1 radii are O(10): at 224² a
    budget of 12 averages under 4e-4 a pixel."""
    eps, alpha = float(eps), float(alpha)
    x_orig = x
    b = x.shape[0]
    n = x[0].numel()
    if random_start:
        noise, scale = draw_l1_start(x.shape, generator, x.device)
        delta0 = project_l1_ball(noise.to(x.dtype), eps) * scale.to(x.dtype)
        x_adv = torch.clamp(x_orig + delta0, 0.0, 1.0)
    else:
        x_adv = x_orig

    y_grad = y_true if y_target is None else y_target
    direction = 1.0 if y_target is None else -1.0
    k = max(1, int(round(sparsity * n)))
    for _ in range(int(steps)):
        g = input_grad(logits_fn, x_adv, y_grad).reshape(b, -1)
        gf = torch.abs(g)
        # the k-th largest |g| by value: the (n-k+1)-th smallest
        thr = torch.kthvalue(gf, n - k + 1, dim=-1).values[:, None]
        e = torch.sign(g) * (gf >= thr).to(g.dtype)
        e = e / torch.clamp_min(torch.sum(torch.abs(e), dim=-1, keepdim=True), 1.0)
        x_new = x_adv + alpha * direction * e.reshape(x.shape)
        x_new = x_orig + project_l1_ball(x_new - x_orig, eps)
        x_adv = torch.clamp(x_new, 0.0, 1.0)
    return x_adv


def pgd_multi_restart(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor,
                      *, eps: float, alpha: float, steps: int,
                      generator: torch.Generator, restarts: int = 5) -> torch.Tensor:
    """Worst case over ``restarts`` random starts of PGD-L∞: per sample, the
    restart whose iterate has the highest CE; a tie keeps the earlier
    restart (``jnp.argmax``'s first maximum).

    The JAX package vmaps the restarts into one [R·B] attack.  Here they run
    one after another, each ``pgd_linf_attack`` drawing its start from
    ``generator``, so memory stays that of one attack and a CUDA run
    launches R noise and R·steps pgd_step kernels.
    """
    best_adv = best_ce = None
    for _ in range(int(restarts)):
        x_adv = pgd_linf_attack(logits_fn, x, y_true, eps=eps, alpha=alpha, steps=steps,
                                generator=generator)
        with torch.no_grad():
            ce = per_sample_ce(logits_fn(x_adv), y_true)
        if best_adv is None:
            best_adv, best_ce = x_adv, ce
            continue
        better = ce > best_ce
        best_adv = torch.where(better[:, None, None, None], x_adv, best_adv)
        best_ce = torch.where(better, ce, best_ce)
    return best_adv
