"""APGD: Auto-PGD with the CE, DLR and targeted-DLR losses (Croce & Hein,
ICML 2020; port of ``attacks/apgd.py``).

Momentum steps with a per-sample step size that halves at the paper's
checkpoints when progress stalls, restarting from the best iterate; the
result is the best-loss iterate.  APGD-T restarts targeted DLR over the
top-K runner-up classes of the clean logits.

The JAX package runs the attack as one ``lax.scan`` over the precomputed
checkpoint flags; here it is a Python loop with the same order of
operations, its per-sample state held in tensors: the step size ``eta``,
the improvement counters, ``halved_prev`` and ``ckpt_best``.  The step
before the loop is iteration 1 of the budget, so ``steps`` gradient
evaluations follow the random-start probe.  After a restart from an older
best iterate, the next update uses the gradient of the iterate it jumped
from (one step stale, the JAX package's documented choice: it saves a
second forward+backward at checkpoints).

The L∞ random start is ``draw_start``: the Philox noise kernel on a CUDA
device, its plain version on the CPU; the L2 start is a normal direction
scaled onto the sphere.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.rng import standard_normal
from . import pgd
from .api import LogitsFn, per_sample_ce


def apgd_checkpoints(steps: int) -> np.ndarray:
    """Boolean [steps], True at the paper's checkpoint iterations:
    p_0=0, p_1=0.22, p_{j+1} = p_j + max(p_j - p_{j-1} - 0.03, 0.06);
    w_j = ceil(p_j * steps)."""
    ps = [0.0, 0.22]
    while ps[-1] < 1.0:
        ps.append(ps[-1] + max(ps[-1] - ps[-2] - 0.03, 0.06))
    ws = sorted({int(np.ceil(p * steps)) for p in ps if 0 < p < 1.0})
    flags = np.zeros((steps,), bool)
    for w in ws:
        if w < steps:
            flags[w] = True
    return flags


def draw_start(shape, eps: float, generator: torch.Generator, device: torch.device | str,
               norm: str) -> torch.Tensor:
    """The random start's draw: Uniform(-eps, eps) from the noise kernel for
    'linf', a standard normal (scaled onto the sphere by the caller) for
    'l2'; float32 on ``device``."""
    if norm == "linf":
        return pgd.draw_start(shape, eps, generator, device)
    return standard_normal(shape, generator, device)


def _pick(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.gather(logits, -1, y[:, None].long())[:, 0]


def dlr_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Untargeted Difference-of-Logits-Ratio (Croce & Hein 2020, eq. 6):
    ``-(z_y - max_{i != y} z_i) / (z_pi1 - z_pi3 + 1e-12)``; [B,C] -> [B]."""
    if logits.shape[-1] < 3:
        raise ValueError(
            f"DLR needs >= 3 classes (got {logits.shape[-1]}): the "
            "normalizer is z_pi1 - z_pi3")
    z_sorted = torch.sort(logits, dim=-1, stable=True).values  # ascending
    z_y = _pick(logits, y)
    onehot = F.one_hot(y.long(), logits.shape[-1]).bool()
    z_other = torch.amax(torch.where(onehot, -torch.inf, logits), dim=-1)
    denom = z_sorted[:, -1] - z_sorted[:, -3] + 1e-12
    return -(z_y - z_other) / denom


def dlr_loss_targeted(logits: torch.Tensor, y: torch.Tensor,
                      y_target: torch.Tensor) -> torch.Tensor:
    """Targeted DLR (Croce & Hein 2020, eq. 7):
    ``-(z_y - z_t) / (z_pi1 - (z_pi3 + z_pi4) / 2 + 1e-12)``."""
    if logits.shape[-1] < 4:
        raise ValueError(
            f"targeted DLR needs >= 4 classes (got {logits.shape[-1]}): the "
            "normalizer is z_pi1 - (z_pi3 + z_pi4)/2")
    z_sorted = torch.sort(logits, dim=-1, stable=True).values
    denom = z_sorted[:, -1] - 0.5 * (z_sorted[:, -3] + z_sorted[:, -4]) + 1e-12
    return -(_pick(logits, y) - _pick(logits, y_target)) / denom


def _make_loss(loss: str, y_true, y_target=None):
    """name -> the logits-space [B] loss the attack maximizes."""
    if loss == "ce":
        return lambda logits: per_sample_ce(logits, y_true)
    if loss == "dlr":
        return lambda logits: dlr_loss(logits, y_true)
    if loss == "dlr-targeted":
        if y_target is None:
            raise ValueError("dlr-targeted needs y_target")
        return lambda logits: dlr_loss_targeted(logits, y_true, y_target)
    raise ValueError(f"unknown APGD loss '{loss}'")


def apgd_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                eps: float, steps: int = 100, generator: torch.Generator,
                loss: str = "ce", y_target: torch.Tensor | None = None,
                rho: float = 0.75, alpha_momentum: float = 0.75,
                norm: str = "linf") -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> the best-loss adversarial batch in [0,1].

    APGD maximizing ``loss`` ('ce' | 'dlr' | 'dlr-targeted') inside the
    eps-ball of ``norm`` ('linf' | 'l2').  L2 follows the paper: a start on
    the sphere, L2-normalized gradient steps, a radial rescale of the delta
    then the box clip.
    """
    if norm not in ("linf", "l2"):
        raise ValueError(f"unknown APGD norm '{norm}'")
    eps = float(eps)
    b = x.shape[0]
    x_orig = x
    axes = tuple(range(1, x.ndim))
    loss_vec = _make_loss(loss, y_true, y_target)

    def expand(v):
        return v[:, None, None, None]

    def clip_ball(z):
        if norm == "linf":
            return torch.clamp(torch.clamp(z, x_orig - eps, x_orig + eps), 0.0, 1.0)
        delta = z - x_orig
        nrm = torch.sqrt(torch.sum(torch.square(delta), dim=axes, keepdim=True))
        delta = delta * torch.clamp_max(eps / (nrm + 1e-12), 1.0)
        return torch.clamp(x_orig + delta, 0.0, 1.0)

    def step_dir(grad):
        """the ascent direction, scaled so that eta is the distance moved"""
        if norm == "linf":
            return torch.sign(grad)
        nrm = torch.sqrt(torch.sum(torch.square(grad), dim=axes, keepdim=True))
        return grad / (nrm + 1e-12)

    def loss_and_grad(z):
        zg = z.detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss_vec(logits_fn(zg))
            (grad,) = torch.autograd.grad(torch.sum(value), zg)
        return value.detach(), grad

    # the random start, then one plain step at eta0 = 2*eps
    noise = draw_start(x.shape, eps, generator, x.device, norm).to(x.dtype)
    if norm == "l2":
        g_nrm = torch.sqrt(torch.sum(torch.square(noise), dim=axes, keepdim=True))
        noise = eps * noise / (g_nrm + 1e-12)  # on the sphere, as in the paper
    x0 = clip_ball(x_orig + noise)
    loss0, grad0 = loss_and_grad(x0)
    eta = torch.full((b,), 2.0 * eps, dtype=x.dtype, device=x.device)
    x1 = clip_ball(x0 + expand(eta) * step_dir(grad0))
    loss1, grad1 = loss_and_grad(x1)

    better1 = loss1 > loss0
    x_k, x_prev, grad, loss_k = x1, x0, grad1, loss1
    x_best = torch.where(expand(better1), x1, x0)
    loss_best = torch.maximum(loss0, loss1)
    improved = better1.to(torch.int32)  # improvements since the last checkpoint
    since = torch.ones((b,), dtype=torch.int32, device=x.device)  # steps since it
    # AutoAttack's reduced_last_check and the best loss at the last checkpoint
    halved_prev = torch.zeros((b,), dtype=torch.bool, device=x.device)
    ckpt_best = loss_best

    # the step above is iteration 1 of the budget: the loop covers 1..steps-1
    for is_ckpt in apgd_checkpoints(int(steps))[1:]:
        # the momentum step (paper eq. 2-3) at each sample's eta
        z = clip_ball(x_k + expand(eta) * step_dir(grad))
        x_new = clip_ball(x_k + alpha_momentum * (z - x_k)
                          + (1.0 - alpha_momentum) * (x_k - x_prev))
        loss_new, grad_new = loss_and_grad(x_new)

        gained = loss_new > loss_k
        x_best = torch.where(expand(loss_new > loss_best), x_new, x_best)
        loss_best = torch.maximum(loss_best, loss_new)
        improved_cnt = improved + gained.to(torch.int32)
        since = since + 1
        if not is_ckpt:
            x_prev, x_k, grad, loss_k, improved = x_k, x_new, grad_new, loss_new, improved_cnt
            continue

        # at a checkpoint, halve eta (and restart from the best iterate) when
        # (1) too few steps improved since the last checkpoint, or
        # (2) eta was not halved at the last checkpoint and the best loss
        #     has not improved since
        cond1 = improved_cnt < torch.ceil(rho * since).to(torch.int32)
        cond2 = (~halved_prev) & (ckpt_best >= loss_best)
        halve = cond1 | cond2
        eta = torch.where(halve, eta / 2.0, eta)
        x_prev = torch.where(expand(halve), x_best, x_k)
        x_k = torch.where(expand(halve), x_best, x_new)
        loss_k = torch.where(halve, loss_best, loss_new)
        # the gradient of x_new: one step stale after a restart to an older
        # best iterate (the module docstring)
        grad = grad_new
        improved = torch.zeros_like(improved_cnt)
        since = torch.zeros_like(since)
        halved_prev = halve
        ckpt_best = loss_best
    return x_best


def apgd_ce_attack(logits_fn, x, y_true, *, eps, steps: int = 100, generator,
                   rho: float = 0.75, alpha_momentum: float = 0.75, norm: str = "linf"):
    """APGD maximizing the untargeted cross-entropy (AutoAttack's first arm)."""
    return apgd_attack(logits_fn, x, y_true, eps=eps, steps=steps, generator=generator,
                       loss="ce", rho=rho, alpha_momentum=alpha_momentum, norm=norm)


def apgd_dlr_attack(logits_fn, x, y_true, *, eps, steps: int = 100, generator,
                    rho: float = 0.75, alpha_momentum: float = 0.75, norm: str = "linf"):
    """APGD maximizing the untargeted DLR, which resists gradient masking."""
    return apgd_attack(logits_fn, x, y_true, eps=eps, steps=steps, generator=generator,
                       loss="dlr", rho=rho, alpha_momentum=alpha_momentum, norm=norm)


def runner_up_targets(logits_clean: torch.Tensor, n_targets: int) -> torch.Tensor:
    """[K,B]: the classes ranked 2..K+1 by clean logit, from a stable
    descending sort (``jnp.argsort(-logits)``: ties keep the lower index;
    bf16 logits of 1000 classes often tie)."""
    order = torch.argsort(-logits_clean, dim=-1, stable=True)
    return order[:, 1:1 + n_targets].T


def apgd_targeted_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                         eps: float, steps: int = 100, n_targets: int = 9,
                         generator: torch.Generator, rho: float = 0.75,
                         alpha_momentum: float = 0.75,
                         norm: str = "linf") -> tuple[torch.Tensor, torch.Tensor]:
    """APGD-T: targeted-DLR restarts over the top-``n_targets`` runner-up
    classes of the clean logits, one APGD run each, in turn.

    Returns ``(x_adv, success)``: per sample, the first restart's iterate
    that flips the prediction (success = pred != y_true), else the last
    restart's best-loss iterate.
    """
    with torch.no_grad():
        logits_clean = logits_fn(x)
    n_targets = int(min(n_targets, logits_clean.shape[-1] - 1))
    targets = runner_up_targets(logits_clean, n_targets)
    x_adv = x
    success = torch.zeros(x.shape[:1], dtype=torch.bool, device=x.device)
    for y_t in targets:
        x_try = apgd_attack(logits_fn, x, y_true, eps=eps, steps=steps, generator=generator,
                            loss="dlr-targeted", y_target=y_t, rho=rho,
                            alpha_momentum=alpha_momentum, norm=norm)
        with torch.no_grad():
            fooled = torch.argmax(logits_fn(x_try), dim=-1) != y_true
        # a sample that already succeeded keeps its first winning iterate;
        # every other takes the latest try
        x_adv = torch.where((~success)[:, None, None, None], x_try, x_adv)
        success = success | fooled
    return x_adv, success
