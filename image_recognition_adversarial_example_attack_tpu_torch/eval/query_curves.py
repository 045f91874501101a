"""Query-efficiency curves of the black-box attacks (port of
``eval/query_curves.py``): attack-success rate as a function of the model-query
budget.

Every supported attack returns its per-step success mask
(``return_history=True``), so one run at the largest budget gives the whole
curve: the success at a step is the running maximum of the mask, and steps
convert to queries by each attack's per-step cost.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..attacks.api import LogitsFn

CURVE_ATTACKS = ("square", "square_l2", "simba", "nes", "spsa", "bandits")


def _runner(attack: str, logits_fn: LogitsFn, *, eps: float, steps: int, est_samples: int,
            nes_sigma: float, spsa_delta: float, alpha: float, simba_eps: float,
            simba_mode: str) -> tuple[Callable, int, int]:
    """(fn(x, y, generator) -> (x_adv, succ_hist [steps,B]), queries a step,
    initial queries)."""
    if attack == "square":
        from ..attacks.square import square_attack

        return (lambda x, y, g: square_attack(logits_fn, x, y, eps=eps, steps=steps,
                                              generator=g, return_history=True)), 1, 2
    if attack == "square_l2":
        from ..attacks.square import square_l2_attack

        return (lambda x, y, g: square_l2_attack(logits_fn, x, y, eps=eps, steps=steps,
                                                 generator=g, return_history=True)), 1, 2
    if attack == "simba":
        from ..attacks.simba import simba_attack

        return (lambda x, y, g: simba_attack(logits_fn, x, y, steps=steps, eps=simba_eps,
                                             mode=simba_mode, generator=g,
                                             return_history=True)), 2, 1
    if attack in ("nes", "spsa"):
        from ..attacks.grad_est import nes_attack, spsa_attack

        fn = nes_attack if attack == "nes" else spsa_attack
        kw = {"sigma": nes_sigma} if attack == "nes" else {"delta": spsa_delta}
        return (lambda x, y, g: fn(logits_fn, x, y, eps=eps, alpha=alpha, steps=steps,
                                   generator=g, n_samples=est_samples, return_history=True,
                                   **kw)), 2 * est_samples, 0
    if attack == "bandits":
        from ..attacks.bandits import bandits_attack

        return (lambda x, y, g: bandits_attack(logits_fn, x, y, eps=eps, alpha=alpha,
                                               steps=steps, generator=g,
                                               return_history=True)), 2, 0
    raise ValueError(f"no query-curve support for attack '{attack}'")


def history_stats(hist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The curve's two reductions over samples of one [steps, B] success
    history: the per-step count of samples that ever succeeded ([steps]) and
    each sample's first-success step ([B], -1 = never).  Success is
    sticky."""
    ever = np.maximum.accumulate(np.asarray(hist, bool), axis=0)
    first = np.where(ever.any(axis=0), ever.argmax(axis=0), -1)
    return ever.sum(axis=1), first


def query_curve(attack: str, logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor, *,
                eps: float, max_queries: int, generator: torch.Generator,
                est_samples: int = 32, nes_sigma: float = 1e-3, spsa_delta: float = 1e-2,
                alpha: float = 2 / 255, simba_eps: float = 0.2,
                simba_mode: str = "dct") -> dict:
    """One attack run at the largest budget -> the exact ASR-vs-queries curve:
    ``{"attack", "queries", "asr", "final_asr", "median_queries_to_success"}``
    where ``queries[i]`` is the query count after step i+1 and ``asr[i]`` the
    fraction of the batch fooled within it."""
    steps = budget_to_steps(attack, max_queries, est_samples)
    fn, per_step, init_q = _runner(attack, logits_fn, eps=eps, steps=steps,
                                   est_samples=est_samples, nes_sigma=nes_sigma,
                                   spsa_delta=spsa_delta, alpha=alpha, simba_eps=simba_eps,
                                   simba_mode=simba_mode)
    _, hist = fn(x, y, generator)
    hist = hist.cpu().numpy()  # [steps, B] bool, the run's one read
    ever_count, first = history_stats(hist)
    return assemble_curve(attack, ever_count, hist.shape[1], first, per_step=per_step,
                          init_q=init_q, steps=steps)


def budget_to_steps(attack: str, max_queries: int, est_samples: int = 32) -> int:
    """The step count of a query budget (at least 1), from each attack's
    per-step and initial query costs."""
    probe_cost = {"square": 1, "square_l2": 1, "simba": 2, "bandits": 2,
                  "nes": 2 * est_samples, "spsa": 2 * est_samples}[attack]
    init_q = {"square": 2, "square_l2": 2, "simba": 1, "bandits": 0,
              "nes": 0, "spsa": 0}[attack]
    return max(1, (int(max_queries) - init_q) // probe_cost)


def assemble_curve(attack: str, ever_count: np.ndarray, count: int, first: np.ndarray, *,
                   per_step: int, init_q: int, steps: int) -> dict:
    """The curve dict from the two streamable reductions (``history_stats``),
    shared by the one-batch path and ``eval.streaming.stream_query_curve_hist``,
    so both give the same JSON for the same statistics."""
    asr = np.asarray(ever_count, np.float64) / max(int(count), 1)
    queries = init_q + per_step * np.arange(1, steps + 1)
    first = np.asarray(first)
    solved = first >= 0
    median_q = (float(np.median(init_q + per_step * (first[solved] + 1)))
                if solved.any() else None)
    return {
        "attack": attack,
        "queries": [int(q) for q in queries],
        "asr": [float(a) for a in asr],
        "final_asr": float(asr[-1]),
        "median_queries_to_success": median_q,
    }


def curve_at_checkpoints(curve: dict, checkpoints) -> list[tuple[int, float]]:
    """The curve at ascending query checkpoints: the ASR at the largest
    computed budget <= the checkpoint, 0.0 before the first."""
    qs = np.asarray(curve["queries"])
    asr = np.asarray(curve["asr"])
    out = []
    for cp in checkpoints:
        idx = np.searchsorted(qs, cp, side="right") - 1
        out.append((int(cp), float(asr[idx]) if idx >= 0 else 0.0))
    return out
