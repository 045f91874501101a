"""DeepFool: the minimal-L2 step to the nearest linearized boundary
(Moosavi-Dezfooli et al., CVPR 2016; port of ``attacks/deepfool.py``).

Each iteration linearizes the classifier at the current iterate and moves to
the closest boundary among the top-``num_classes`` candidate classes (ranked
by clean logits):

    l  = argmin_k |f_k - f_k0| / ||w_k - w_k0||
    r  = (|f_l - f_k0| + eta) / ||w_l - w_k0||^2 * (w_l - w_k0)

where k0 is the model's own clean prediction (any label passed is ignored).
The accumulated perturbation is overshot by ``(1 + overshoot)``, and a
sample stops moving once fooled.

The JAX package takes one vjp and vmaps it over k one-hot cotangents; here
one forward a step is followed by k backward passes through its graph
(``retain_graph``), one per candidate class: the gradient of the summed
logit of that class.  The candidates come from a stable descending sort, so
ties keep the lower class index, as ``lax.top_k`` does.  It has no kernel.
"""

from __future__ import annotations

import torch

from .api import LogitsFn


def deepfool_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor | None = None,
                    *, steps: int = 50, num_classes: int = 10, overshoot: float = 0.02,
                    eta: float = 1e-4) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1] (``y_true`` is
    accepted for the dispatch's sake and not used).  Iterates are clipped to
    [0,1]; fooled samples stop updating."""
    del y_true
    with torch.no_grad():
        logits0 = logits_fn(x)
    k = min(int(num_classes), logits0.shape[-1])
    # column 0 is the clean prediction k0 (the top-1)
    idx = torch.argsort(-logits0, dim=-1, stable=True)[:, :k]  # [B, k]
    k0 = idx[:, 0]
    rows = torch.arange(x.shape[0], device=x.device)

    r_tot = torch.zeros_like(x)
    for _ in range(int(steps)):
        x_adv = torch.clamp(x + (1.0 + overshoot) * r_tot, 0.0, 1.0).requires_grad_(True)
        with torch.enable_grad():
            f_full = logits_fn(x_adv)
            grads = torch.stack([
                torch.autograd.grad(torch.sum(f_full[rows, idx[:, j]]), x_adv,
                                    retain_graph=j < k - 1)[0]
                for j in range(k)])  # [k, B, H, W, C]
        f_full = f_full.detach()

        f_sel = torch.gather(f_full, -1, idx)              # [B, k]
        w = grads[1:] - grads[:1]                          # [k-1, B, H, W, C]
        f_diff = (f_sel[:, 1:] - f_sel[:, :1]).T           # [k-1, B]
        w_norm = torch.sqrt(torch.sum(torch.square(w), dim=(2, 3, 4)))  # [k-1, B]
        dist = torch.abs(f_diff) / torch.clamp_min(w_norm, 1e-12)

        l = torch.argmin(dist, dim=0)  # [B]: the nearest linearized boundary
        w_l = w[l, rows]
        fd_l = torch.abs(f_diff)[l, rows]
        wn_l = w_norm[l, rows]
        step = ((fd_l + eta)[:, None, None, None] * w_l
                / torch.clamp_min(wn_l, 1e-12)[:, None, None, None] ** 2)

        fooled = torch.argmax(f_full, dim=-1) != k0  # [B]
        r_tot = torch.where(fooled[:, None, None, None], r_tot, r_tot + step)
    return torch.clamp(x + (1.0 + overshoot) * r_tot, 0.0, 1.0)
