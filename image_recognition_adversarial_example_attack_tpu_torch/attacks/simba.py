"""SimBA: simple black-box attack by coordinate descent on the true class's
probability (Guo et al., ICML 2019; port of ``attacks/simba.py``).

Per step each sample draws one orthonormal direction q, tries ``x + eps*q``
and keeps it if p_y drops, else tries ``x - eps*q``.  ``mode='pixel'``: q is
one (i, j, c) indicator; ``mode='dct'``: q is a 2-D DCT basis image of the
lowest ``freq_frac`` of frequencies on one channel (built as a cosine outer
product, never as an [HWC x HWC] basis).

One stacked [2B] forward a step evaluates both signed candidates.  A sample
already misclassified (at the start, or after an accepted step) is
``done``: masked out, it keeps its image.  The per-step draws (u, v, channel)
of every step come from one call before the loop, on the device
(``draw_simba``, the tests' patch point).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.rng import device_generator, randint_below
from .api import LogitsFn, success_history


def dct_basis_image(u, v, h: int, w: int, dtype=torch.float32) -> torch.Tensor:
    """Orthonormal 2-D DCT-II basis image at frequency (u, v) -> [H, W], or
    [B, H, W] for [B] tensors of frequencies.  ``sum(q*q) == 1``, so an eps
    step along q moves the image by eps in L2."""
    u = torch.as_tensor(u)
    v = torch.as_tensor(v, device=u.device)
    i = torch.arange(h, dtype=dtype, device=u.device)
    j = torch.arange(w, dtype=dtype, device=u.device)
    ci = torch.cos(math.pi * (i + 0.5) * u.to(dtype)[..., None] / h)
    cj = torch.cos(math.pi * (j + 0.5) * v.to(dtype)[..., None] / w)

    def scale(f, n):  # sqrt(1/n) at frequency 0, else sqrt(2/n), in ``dtype``
        one, two = (torch.tensor(math.sqrt(k / n), dtype=dtype, device=u.device)
                    for k in (1.0, 2.0))
        return torch.where(f == 0, one, two)

    au, av = scale(u, h), scale(v, w)
    return (au * av)[..., None, None] * ci[..., :, None] * cj[..., None, :]


def draw_simba(steps: int, b: int, fh: int, fw: int, c: int, generator: torch.Generator,
               device: torch.device | str):
    """Every step's coordinates, int64 [steps,B] each on ``device``: the
    frequency (or pixel) row ``u`` in [0, fh), column ``v`` in [0, fw) and
    the channel in [0, c)."""
    g = device_generator(generator, device)

    def below(n):
        return randint_below(torch.full((int(steps),), int(n), device=device), b, g)

    return below(fh), below(fw), below(c)


def simba_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                 steps: int = 1000, eps: float = 0.2, mode: str = "dct",
                 freq_frac: float = 0.125, generator: torch.Generator,
                 return_history: bool = False):
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1].

    ``steps`` coordinate trials (two queries each, one stacked forward);
    ``eps`` the step along a direction (paper: 0.2); ``freq_frac`` the
    lowest fraction of DCT frequencies per axis (paper: 1/8 on ImageNet).
    With ``return_history`` also the per-step ``done`` mask [steps, B]."""
    if mode not in ("pixel", "dct"):
        raise ValueError(f"unknown simba mode '{mode}'")
    eps = float(eps)
    b, h, w, c = x.shape
    x0 = torch.clamp(x, 0.0, 1.0)
    if mode == "dct":
        fh, fw = max(1, int(h * freq_frac)), max(1, int(w * freq_frac))
    else:
        fh, fw = h, w
    us, vs, cs = draw_simba(int(steps), b, fh, fw, c, generator, x.device)

    def probs_and_pred(xq, yq):
        logits = logits_fn(xq)
        p = torch.softmax(logits, dim=-1)
        return torch.gather(p, -1, yq[:, None].long())[:, 0], torch.argmax(logits, dim=-1)

    def make_q(uu, vv, cc):
        """Each sample's direction [B,H,W,C], unit L2."""
        if mode == "dct":
            plane = dct_basis_image(uu, vv, h, w, x0.dtype)
        else:
            plane = F.one_hot(uu * w + vv, h * w).to(x0.dtype).reshape(b, h, w)
        chan = F.one_hot(cc, c).to(x0.dtype)
        return plane[..., None] * chan[:, None, None, :]

    with torch.no_grad():
        py, pred0 = probs_and_pred(x0, y_true)
        y2 = torch.cat([y_true, y_true], 0)
        done = pred0 != y_true  # already misclassified: spend no queries
        x_adv = x0
        hist = []
        for i in range(int(steps)):
            q = make_q(us[i], vs[i], cs[i])
            cand_p = torch.clamp(x_adv + eps * q, 0.0, 1.0)
            cand_m = torch.clamp(x_adv - eps * q, 0.0, 1.0)
            pys, preds = probs_and_pred(torch.cat([cand_p, cand_m], 0), y2)
            py_p, py_m = pys[:b], pys[b:]
            pred_p, pred_m = preds[:b], preds[b:]
            take_p = (py_p < py) & ~done
            take_m = (py_m < py) & ~take_p & ~done
            x_adv = torch.where(take_p[:, None, None, None], cand_p,
                                torch.where(take_m[:, None, None, None], cand_m, x_adv))
            py = torch.where(take_p, py_p, torch.where(take_m, py_m, py))
            done = done | (take_p & (pred_p != y_true)) | (take_m & (pred_m != y_true))
            if return_history:
                hist.append(done)
    if return_history:
        return x_adv, success_history(hist, x)
    return x_adv
