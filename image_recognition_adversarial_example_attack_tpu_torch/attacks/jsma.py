"""JSMA: the Jacobian-based Saliency Map Attack (Papernot et al., EuroS&P
2016; port of ``attacks/jsma.py``), the zoo's L0 threat model.

The greedy single-feature form: each step scores every (pixel, channel)
feature by the Papernot saliency, the product of "helps the target class"
and "hurts the other classes", in both directions; moves the best feature
by ``theta`` (clipped to [0,1]), bans it, and repeats up to ``steps`` times
(the L0 budget).  A sample freezes once the model predicts its target.

Each step takes two gradients of one forward (the target logit's sum and
the sum of all logits, two backward passes) and one more forward at the
moved batch.  When no feature is admissible both saliency maxima are 0,
both argmaxes are index 0, ``go_up`` (``>=``) holds and nothing moves, as in
the JAX package.  The JAX ``.at[].add`` / ``.at[].set`` scatter one feature
a sample: ``index_put_`` on a flat view.  It has no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .api import LogitsFn


def jsma_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                steps: int = 100, theta: float = 1.0,
                y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch differing from x in at most
    ``steps`` features, each moved by ``theta`` and clipped to [0,1].

    Targeted toward ``y_target``; by default the clean runner-up class (the
    easiest misclassification).
    """
    b = x.shape[0]
    n = x.shape[1] * x.shape[2] * x.shape[3]
    rows = torch.arange(b, device=x.device)
    with torch.no_grad():
        logits_clean = logits_fn(x)
    if y_target is None:
        # the runner-up: the top class that is not y_true
        masked = torch.where(F.one_hot(y_true.long(), logits_clean.shape[-1]).bool(),
                             -torch.inf, logits_clean)
        y_target = torch.argmax(masked, dim=-1)

    def target_and_all_grads(x_adv):
        xg = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            z = logits_fn(xg)
            target_sum = torch.sum(torch.gather(z, -1, y_target[:, None].long()))
            (grad_t,) = torch.autograd.grad(target_sum, xg, retain_graph=True)
            (grad_all,) = torch.autograd.grad(torch.sum(z), xg)
        return grad_t.reshape(b, n), grad_all.reshape(b, n)

    x_adv = x
    banned = torch.zeros((b, n), dtype=torch.bool, device=x.device)
    done = torch.argmax(logits_clean, dim=-1) == y_target
    for _ in range(int(steps)):
        grad_t, grad_all = target_and_all_grads(x_adv)
        grad_o = grad_all - grad_t
        x_flat = x_adv.reshape(b, n)

        # the Papernot saliency in both directions, where the feature can move
        can_up = x_flat < 1.0
        can_dn = x_flat > 0.0
        sal_up = torch.where((grad_t > 0) & (grad_o < 0) & can_up & ~banned,
                             grad_t * (-grad_o), 0.0)
        sal_dn = torch.where((grad_t < 0) & (grad_o > 0) & can_dn & ~banned,
                             (-grad_t) * grad_o, 0.0)

        best_up = torch.argmax(sal_up, dim=-1)  # the first maximum, as jnp.argmax
        best_dn = torch.argmax(sal_dn, dim=-1)
        val_up = sal_up[rows, best_up]
        val_dn = sal_dn[rows, best_dn]
        go_up = val_up >= val_dn
        idx = torch.where(go_up, best_up, best_dn)
        delta = torch.where(go_up, theta, -theta).to(x.dtype)
        # no admissible feature (both maxima zero): change nothing
        viable = torch.maximum(val_up, val_dn) > 0.0
        active = viable & ~done
        move = torch.where(active, delta, 0.0)

        x_new = x_flat.clone()
        x_new.index_put_((rows, idx), move, accumulate=True)
        x_adv = torch.clamp(x_new, 0.0, 1.0).reshape(x.shape)
        banned.index_put_((rows, idx), banned[rows, idx] | active)
        with torch.no_grad():
            pred = torch.argmax(logits_fn(x_adv), dim=-1)
        done = done | (pred == y_target)
    return x_adv
