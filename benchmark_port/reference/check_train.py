"""The reference's check of the first training steps that the program ran:
Madry PGD-AT (a PGD-L-inf inner maximization from the uniform start, then
one AdamW update on the mean cross-entropy of the adversarial batch) in
float32, with frozen BatchNorm statistics, from the same weights, batches
and draws.

The reference follows the program's first ``n`` steps from the initial
weights on its own: its own float32 PGD iterates and its own updates.  The
numbers, each a gap of norms taken by the worst leaf:

- ``loss_gap``: the largest ``|loss_program - loss_reference| / loss_reference``
  over the steps;
- ``grad_norm_gap``: over the leaves, ``| |g_program| - |g_reference| |``
  over the larger of the reference leaf's norm and the median leaf's, for
  the first step's gradient (the program's as its AdamW got it: the first
  moment after one step over ``1 - b1``);
- ``update_norm_gap``: the same for the parameters' change after ``n``
  steps.

Leaves whose reference gradient is below a thousandth of the median leaf's
norm are left out of the two gaps of norms (a rule on the reference's
gradient: AdamW moves such leaves by round-off alone).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (its absolute maximum onto 448),
    back in float32; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def adamw(params, grads, mu, nu, count, lr, wd):
    """optax.adamw's update (scale_by_adam, + wd * p, * -lr), in float32."""
    out_p, out_mu, out_nu = {}, {}, {}
    count += 1
    for k, p in params.items():
        g = grads[k]
        m = (1 - B1) * g + B1 * mu[k]
        v = (1 - B2) * g * g + B2 * nu[k]
        u = (m / (1 - B1 ** count)) / (torch.sqrt(v / (1 - B2 ** count)) + ADAM_EPS)
        out_p[k] = p - lr * (u + wd * p)
        out_mu[k], out_nu[k] = m, v
    return out_p, out_mu, out_nu, count


def _logits(forward, sd, config, x01, mean, std, cast):
    return forward(((x01 - mean) / std).permute(0, 3, 1, 2), sd, config, cast=cast)


def run_steps(forward, sd0, trained, config, batches, plain, traffic, device, cast=None,
              block: int = 64):
    """The reference's steps: [(x, y, attack generator)] -> (losses, first
    gradient, parameters after the last step)."""
    cast = cast or (lambda t: t)
    eps, alpha, steps = float(traffic["eps"]), float(traffic["alpha"]), int(traffic["attack_steps"])
    mean = torch.tensor(config["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(config["std"], dtype=torch.float32, device=device)
    params = {k: sd0[k].clone() for k in trained}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count, losses, first = 0, [], None
    for x, y, gen in batches:
        frozen = dict(sd0, **{k: v.detach() for k, v in params.items()})
        x_adv = torch.clamp(x + plain.start_noise(x.shape, eps, gen, device), 0.0, 1.0)
        for _ in range(steps):
            grad = torch.empty_like(x_adv)
            for lo in range(0, x.shape[0], block):
                xb = x_adv[lo:lo + block].detach().clone().requires_grad_(True)
                with torch.enable_grad():
                    z = _logits(forward, frozen, config, xb, mean, std, cast)
                    (grad[lo:lo + block],) = torch.autograd.grad(
                        F.cross_entropy(z, y[lo:lo + block], reduction="sum"), xb)
            x_adv = plain.pgd_step(x_adv, torch.sign(grad), x, eps, alpha)
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss = 0.0
        for lo in range(0, x.shape[0], block):
            with torch.enable_grad():
                z = _logits(forward, dict(sd0, **leaves), config, x_adv[lo:lo + block], mean,
                            std, cast)
                part = F.cross_entropy(z, y[lo:lo + block], reduction="sum") / x.shape[0]
                gs = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
            for k, g in zip(leaves, gs):
                if g is not None:
                    grads[k] += g
            loss += float(part.detach())
        losses.append(loss)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        params, mu, nu, count = adamw(params, grads, mu, nu, count,
                                      float(traffic["learning_rate"]),
                                      float(traffic["weight_decay"]))
    return losses, first, params


def norm_gap(program: dict, reference: dict, keep) -> float:
    norms = {k: float(reference[k].norm()) for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(program[k].norm()) - norms[k]) / max(norms[k], median) for k in keep)


def compare(program_losses, program_first, program_last, ref_losses, ref_first, ref_last,
            sd0) -> tuple[dict, list]:
    grad_norms = {k: float(g.norm()) for k, g in ref_first.items()}
    median = sorted(grad_norms.values())[len(grad_norms) // 2]
    keep = [k for k, n in grad_norms.items() if n >= 1e-3 * median]
    delta_p = {k: program_last[k].float() - sd0[k] for k in keep}
    delta_r = {k: ref_last[k] - sd0[k] for k in keep}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(program_losses, ref_losses)),
        "grad_norm_gap": norm_gap(program_first, ref_first, keep),
        "update_norm_gap": norm_gap(delta_p, delta_r, keep),
    }, sorted(set(ref_first) - set(keep))
