"""The reference's check of the defense cell beyond its attack (which
``check_attack`` covers), from the program's own recorded model calls:

- ``cell_mismatch``: elements where the program's clean forward did not
  read the clean batch, its defended forward did not read
  ``defend(x_adv)`` (the frozen smoothing and 16-level quantization), or its
  detector did not read x_adv and the clean batch (exact: limit 0);
- ``counter_mismatch``: the program's per-sample counters and calibrated
  threshold against the same rules applied to the program's own logits and
  features (argmax, the feature score, the 0.95 quantile with its rails;
  exact: limit 0);
- ``score_gap``: over the calibration, adversarial and clean rows, the
  largest ``|score_program - score_reference| / score_reference`` of the
  detector's feature score, the reference's from float32 stage-3 features;
- the clean and defended forwards' logits join ``logit_gap``.
"""

from __future__ import annotations

import torch


def feature_score(feats: torch.Tensor) -> torch.Tensor:
    """The stage-3 feature score of an NHWC map: ``|f|_2 / C`` plus 0.1 times
    the channel mean of the unbiased spatial variance, clipped to [0, 100]."""
    channels = feats.shape[-1]
    l2 = torch.sqrt(torch.sum(torch.square(feats), dim=(1, 2, 3))) / channels
    var = torch.mean(torch.var(feats, dim=(1, 2), correction=1), dim=-1)
    return torch.clamp(l2 + 0.1 * var, 0.0, 100.0)


def threshold(scores: torch.Tensor, quantile: float = 0.95) -> float:
    """The linear quantile, halved above 50, at least 1."""
    thr = float(torch.quantile(scores, quantile))
    return thr * 0.5 if thr > 50.0 else max(thr, 1.0)


def check_defense(cell, seed, device, records, batch_inputs, cal_calls, thr_program: float,
                  levels: int, tally: dict) -> dict:
    ref = cell.piece(f"reference/{cell.config['reference']}")
    plain = cell.piece("reference/plain_kernels")
    chk = cell.piece("reference/check_attack")
    keys = cell.traffic["counters"]
    sd = cell.piece("inputs").make_weights(ref.param_spec(cell.config), ref.POSITIVE, seed, device)
    logits_fn = chk.make_logits_fn(ref.forward, sd, cell.config, device)
    stage3 = chk.make_logits_fn(ref.features_stage3, sd, cell.config, device)
    block = int(cell.traffic.get("check_block", 64))

    @torch.no_grad()
    def ref_score(x):
        return torch.cat([feature_score(stage3(x[lo:lo + block]).permute(0, 2, 3, 1))
                          for lo in range(0, x.shape[0], block)])

    def gap(program_feats, x):
        s_p, s_r = feature_score(program_feats), ref_score(x)
        return float(((s_p - s_r).abs() / s_r.clamp_min(1e-12)).max())

    x_cal, feats_cal = cal_calls[0]
    thr32 = torch.tensor(thr_program, dtype=torch.float32, device=device)
    cell_mm = 0
    counter_mm = int(threshold(feature_score(feats_cal)) != thr_program)
    score_gap = gap(feats_cal, x_cal)
    for i, (calls, fcalls, counters) in records.items():
        x, y = batch_inputs(i)
        steps = int(cell.traffic["steps"])
        clean, adv, defended = calls[0], calls[steps + 1], calls[steps + 2]
        cell_mm += int((clean[0] != x).sum())
        cell_mm += int((defended[0] != plain.defend(adv[0], levels)).sum())
        cell_mm += int((fcalls[0][0] != adv[0]).sum()) + int((fcalls[1][0] != x).sum())
        for inp, z in (clean, defended):
            chk.add_logits(tally, z, chk.logits_only(logits_fn, inp, block))
        flags_adv = (feature_score(fcalls[0][1]) > thr32).int()
        attack_success = (adv[1].argmax(-1) != y).int()
        rules = {
            "clean_correct": (clean[1].argmax(-1) == y).int(),
            "attack_success": attack_success,
            "defense_preproc_success": (defended[1].argmax(-1) == y).int(),
            "detector_flags_clean": (feature_score(fcalls[1][1]) > thr32).int(),
            "detector_flags_adv": flags_adv,
            "detector_attack_success": attack_success * (1 - flags_adv),
        }
        counter_mm += sum(int((counters[k] != rules[k]).sum()) for k in keys)
        score_gap = max(score_gap, gap(fcalls[0][1], adv[0]), gap(fcalls[1][1], x))
    return {"cell_mismatch": float(cell_mm), "counter_mismatch": float(counter_mm),
            "score_gap": score_gap}
