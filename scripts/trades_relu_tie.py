"""On the CPU: how often the TRADES card test's second step has a ReLU input
within float32's rounding of zero, and what that does to its first moment.

``tests/test_torch_cuda.py::test_every_objective_on_the_card_matches_the_cpu[trades]``
replays each card step on the CPU in float32 and float64 with the card's
draws and PGD iterates, and holds the card's first moment (AdamW's ``mu``)
to float64's within a band.  The second step starts from the card's state
after the first, which moves from run to run (cuDNN's float32 sums).  This
script stands in for that: it runs the first TRADES step in float32 on the
CPU, multiplies every parameter by ``1 + rel * N(0, 1)`` (one draw a trial,
seeded by the trial), and runs the second step in float32 and in float64
with the float32 run's draws and PGD iterates.  For each trial it prints
the float32 first moment's distance from float64 (relative to the
first moment's scale), and every ReLU whose input float32 and float64 put
on opposite sides of zero, with both inputs there.

Run from the root of the repository (no card needed):

    python scripts/trades_relu_tie.py --trials 40 --rel 1e-6
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--rel", type=float, default=1e-6,
                    help="relative size of the perturbation of the first step's parameters")
    ap.add_argument("--out", type=str, default=None, help="also write the readings here")
    args = ap.parse_args(argv)

    import pytest
    import torch
    import torch.nn.functional as F

    import test_torch_cuda as t
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import pgd
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial
    from image_recognition_adversarial_example_attack_tpu_torch.train.optim import AdamState

    cpu = torch.device("cpu")
    cfg = adversarial.AdvTrainConfig(**t.OBJECTIVES["trades"])
    step_f, state_f, x, y = t._objective_pair(cpu, "trades", cfg)
    step_d, tmpl_d, _, _ = t._objective_pair(cpu, "trades", cfg, torch.float64)
    homes = {"pgd_step": ew, "draw_start": pgd, "draw_trades_start": adversarial}
    real = {k: getattr(h, k) for k, h in homes.items()}
    real_relu = F.relu
    tape: list = []
    relu_in: list = []

    def relu(v, inplace=False):
        relu_in.append(v.detach().clone())
        return real_relu(v, inplace=inplace)

    def recorded(key):
        def fn(*a):
            out = real[key](*a)
            tape.append(out.detach().clone())
            return out
        return fn

    def replayed(key, at):
        def fn(*a):
            at[0] += 1
            return tape[at[0] - 1]
        return fn

    def in_float64(st):
        to = lambda d: {k: v.double() for k, v in d.items()}  # noqa: E731
        return tmpl_d.replace(
            params=to(st.params), extra_variables=to(st.extra_variables), step=st.step,
            opt_state=AdamState(st.opt_state.count, to(st.opt_state.mu), to(st.opt_state.nu)))

    def second_step(mp, step, st, wrap) -> tuple:
        relu_in.clear()
        for key, home in homes.items():
            mp.setattr(home, key, wrap(key))
        mp.setattr(F, "relu", relu)
        try:
            new, _ = step(st, x, y, chunk_generator(0, "train:0", 1))
        finally:
            mp.setattr(F, "relu", real_relu)
            for key, home in homes.items():
                mp.setattr(home, key, real[key])
        return new.opt_state.mu, list(relu_in)

    rows = []
    with pytest.MonkeyPatch.context() as mp:
        first, _ = step_f(state_f, x, y, chunk_generator(0, "train:0", 0))
        for trial in range(args.trials):
            g = torch.Generator().manual_seed(trial)
            st = first.replace(params={
                k: v * (1 + args.rel * torch.randn(v.shape, generator=g, dtype=v.dtype))
                for k, v in first.params.items()})
            tape.clear()
            mp.setattr(adversarial, "LOSS_DTYPE", torch.float32)
            mu_f, relu_f = second_step(mp, step_f, st, recorded)
            at = [0]
            mp.setattr(adversarial, "LOSS_DTYPE", torch.float64)
            mu_d, relu_d = second_step(mp, step_d, in_float64(st), lambda k: replayed(k, at))
            mp.setattr(adversarial, "LOSS_DTYPE", torch.float32)
            scale = max(float(v.abs().max()) for v in mu_d.values())
            rel = max(float((mu_f[k].double() - v).abs().max()) for k, v in mu_d.items()) / scale
            ties = []
            for call, (a, b) in enumerate(zip(relu_f, relu_d)):
                part = (a > 0) != (b > 0)
                for idx in part.nonzero().tolist():
                    ties.append({"call": call, "shape": list(a.shape), "index": idx,
                                 "float32": float(a[tuple(idx)]),
                                 "float64": float(b[tuple(idx)])})
            rows.append({"trial": trial, "mu_rel": rel, "ties": ties})
            print(f"trial {trial}: float32 {rel:.3e} of the first moment's scale from float64; "
                  f"{len(ties)} ReLU inputs on opposite sides of zero"
                  + "".join(f"; call {z['call']} {z['shape']} at {z['index']}: float32 "
                            f"{z['float32']:.3e}, float64 {z['float64']:.3e}" for z in ties),
                  flush=True)
    jumps = [r for r in rows if r["mu_rel"] > 1e-5]
    summary = {"trials": len(rows), "rel": args.rel,
               "over_1e-5": len(jumps),
               "over_1e-5_with_a_tie": sum(bool(r["ties"]) for r in jumps),
               "ties_without_a_jump": sum(bool(r["ties"]) for r in rows if r["mu_rel"] <= 1e-5),
               "mu_rel_max": max(r["mu_rel"] for r in rows),
               "mu_rel_max_without_a_tie": max((r["mu_rel"] for r in rows if not r["ties"]),
                                               default=None)}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
