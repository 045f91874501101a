"""The reference's check of a PGD-L-inf attack that the program ran, from the
program's own iterates (the inputs of its model calls) and logits.

For one batch, with the clean images ``x`` and labels ``y``:

- ``start_mismatch``: elements of the first iterate that differ from
  ``clip(x + noise, 0, 1)``, the noise drawn again from the attack's
  generator by the frozen copy of the noise kernel (exact: limit 0);
- ``step_mismatch``: elements of each next iterate that no update
  ``clip(clip(x_k + alpha * s, x - eps, x + eps), 0, 1)`` with s in
  {-1, 0, 1} gives (exact: limit 0); this holds the eps-ball and the clip;
- ``stalled_rows``: (step, row) pairs whose image the step left exactly as
  it was (exact: limit 0): a sound step moves every element whose gradient
  points into the ball, so a step left out or rows left unattacked read
  high;
- ``grad_sign_miss``: the share of the reference's float32 input-gradient
  mass, at the program's own iterates, on elements whose update went
  against the reference gradient's sign (elements where the updates with
  s = -1, 0, +1 coincide are left out);
- ``logit_gap``: over every recorded call and row, the largest
  ``max_c |z_program - z_reference| / std_c(z_reference)``;
- ``logit_rms``: the root mean square of the same ratio over every logit.

The reference runs in float32 with TF32 off, in blocks of rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_logits_fn(forward, sd, config, device):
    mean = torch.tensor(config["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(config["std"], dtype=torch.float32, device=device)

    def logits(x01):
        return forward(((x01 - mean) / std).permute(0, 3, 1, 2), sd, config)

    return logits


def logits_and_grad(logits_fn, x, y, block: int):
    """float32 logits and d(sum CE)/dx, in blocks of rows."""
    zs, gs = [], []
    for lo in range(0, x.shape[0], block):
        xb = x[lo:lo + block].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            z = logits_fn(xb)
            (g,) = torch.autograd.grad(F.cross_entropy(z, y[lo:lo + block], reduction="sum"), xb)
        zs.append(z.detach())
        gs.append(g)
    return torch.cat(zs), torch.cat(gs)


@torch.no_grad()
def logits_only(logits_fn, x, block: int):
    return torch.cat([logits_fn(x[lo:lo + block]) for lo in range(0, x.shape[0], block)])


def new_tally() -> dict:
    return {"start_mismatch": 0, "step_mismatch": 0, "miss": 0.0, "mass": 0.0, "logit_gap": 0.0,
            "sq": 0.0, "count": 0, "stalled_rows": 0}


def add_logits(tally: dict, z_program, z_reference) -> None:
    ratio = (z_program.float() - z_reference) / z_reference.std(dim=-1, keepdim=True).clamp_min(1e-12)
    tally["logit_gap"] = max(tally["logit_gap"], float(ratio.abs().amax()))
    tally["sq"] += float(ratio.square().sum())
    tally["count"] += ratio.numel()


def check_pgd(tally: dict, logits_fn, plain, x, y, calls, noise, eps: float, alpha: float,
              steps: int, block: int = 64) -> None:
    """Adds one batch's readings to ``tally``.  ``calls``: the program's
    [(input, logits)] of the attack's ``steps`` gradient calls and then the
    call on its output; ``noise``: the start as drawn again."""
    xs = [c[0] for c in calls[:steps + 1]]
    if len(xs) < steps + 1 or any(t.shape != x.shape for t in xs):
        tally["start_mismatch"] += x.numel()  # not the attack that was asked for
        return
    start = torch.clamp(x + noise, 0.0, 1.0)
    tally["start_mismatch"] += int((xs[0] != start).sum())
    for k in range(steps + 1):
        if k == steps:
            z_ref = logits_only(logits_fn, xs[k], block)
        else:
            z_ref, g = logits_and_grad(logits_fn, xs[k], y, block)
        add_logits(tally, calls[k][1], z_ref)
        if k == steps:
            break
        cands = [plain.pgd_step(xs[k], float(s), x, eps, alpha) for s in (-1, 0, 1)]
        match = torch.stack([c == xs[k + 1] for c in cands])
        tally["step_mismatch"] += int((~match.any(dim=0)).sum())
        tally["stalled_rows"] += int((xs[k + 1] == xs[k]).flatten(1).all(dim=1).sum())
        moved = ~((cands[0] == cands[1]) & (cands[1] == cands[2]))
        agree = match.gather(0, (torch.sign(g).long() + 1)[None])[0]
        weight = g.abs() * moved
        tally["miss"] += float((weight * ~agree).sum())
        tally["mass"] += float(weight.sum())


def readings(tally: dict) -> dict:
    return {"start_mismatch": float(tally["start_mismatch"]),
            "step_mismatch": float(tally["step_mismatch"]),
            "stalled_rows": float(tally["stalled_rows"]),
            "grad_sign_miss": tally["miss"] / max(tally["mass"], 1e-30),
            "logit_gap": tally["logit_gap"],
            "logit_rms": (tally["sq"] / max(tally["count"], 1)) ** 0.5}
