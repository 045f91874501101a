"""The attack -> defend -> detect cell: per unit, one fresh batch through
``eval.defense_eval.evaluate_defenses_batch`` (the clean prediction, the
traffic's attack through ``run_attack``, the adversarial prediction, the
preprocessing defense of ``defenses.preprocess.DefenseConfig`` and its
prediction, and the stage-3 feature detector on the adversarial and the
clean batch), on the zoo's model with the benchmark's weights.  Set-up
calibrates the detector's threshold on one clean batch with
``defenses.detector.calibrate_feature_threshold``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

SPAN = "pb."


class Job:
    kind = "eval"

    def __init__(self, cell, seed: int, device, control: bool = False):
        from image_recognition_adversarial_example_attack_tpu_torch.defenses.detector import (
            calibrate_feature_threshold, make_features_fn)
        from image_recognition_adversarial_example_attack_tpu_torch.defenses.preprocess import (
            DefenseConfig)
        from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
            DefenseEvalConfig)

        eval_attack = cell.piece("drivers/eval_attack")
        self.base = eval_attack.Job(cell, seed, device, control=control)
        b, t = self.base.bundle, cell.traffic
        dtype = getattr(torch, cell.config["dtype"])
        self.features_fn = eval_attack.Recorder(
            make_features_fn(b.model, b.mean, b.std, input_dtype=dtype))
        self.levels = int(t["quant_levels"])
        self.config = DefenseEvalConfig(
            attack_name=t["attack"], eps=float(t["eps"]), alpha=float(t["alpha"]),
            steps=int(t["steps"]), detector=t["detector"],
            defense=DefenseConfig(use_jpeg=bool(t["jpeg"]), quant_levels=self.levels))
        x_cal, _ = self.base.batch_inputs("calibration")
        self.features_fn.start()
        self.threshold = calibrate_feature_threshold(self.features_fn, x_cal, n=x_cal.shape[0],
                                                     verbose=False)
        self.cal_calls = self.features_fn.stop()
        self.examples_per_unit = self.base.examples_per_unit
        self.steps_per_unit = self.base.steps_per_unit
        # clean, adversarial and defended forwards, the attack, and two
        # detector passes through the first three stages
        flops = cell.piece(f"flops/{cell.config['flops']}")
        stage3 = flops.stage3_macs(cell.config) / flops.forward_macs(cell.config)
        self.forward_equivalents_per_unit = self.base.batch * (2 * int(t["steps"]) + 3 + 2 * stage3)
        self.work = dict(self.base.work, defended_numel=self.base.work["attack_numel"])
        self.sample, self.records = self.base.sample, {}
        self.counts = torch.zeros(6, dtype=torch.int64, device=device)

    def warm_up(self):
        for w in range(int(self.base.cell.traffic["warmup_batches"])):
            for rec in (self.base.logits_fn, self.features_fn):
                rec.start()
            self._run(f"warm-up {w}")
            for rec in (self.base.logits_fn, self.features_fn):
                rec.recycle(rec.stop())

    def run_sampled(self):
        for i in self.sample:
            self.unit(i)

    def unit(self, index: int):
        record = index in self.sample
        if record:
            self.base.logits_fn.start()
            self.features_fn.start()
        out = self._run(index)
        if record:
            self.records[index] = (self.base.logits_fn.stop(), self.features_fn.stop(),
                                   {k: v for k, v in out.items() if k != "x_adv"})

    def _run(self, index):
        from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
            STAT_KEYS, evaluate_defenses_batch)

        with record_function(SPAN + "inputs"):
            x, y = self.base.batch_inputs(index)
        with record_function(SPAN + "defense_cell"):
            out = evaluate_defenses_batch(self.base.logits_fn, self.features_fn, x, y,
                                          self.threshold, self.config,
                                          self.base.attack_generator(index))
        self.counts += torch.stack([out[k].sum() for k in STAT_KEYS])
        return out

    def free(self):
        self.base.free()
        self.features_fn = None

    def check(self) -> dict:
        cell, base = self.base.cell, self.base
        eval_attack = cell.piece("drivers/eval_attack")
        chk = cell.piece("reference/check_defense")
        attack_calls = {i: r[0][1:] for i, r in self.records.items()}
        chk_attack = cell.piece("reference/check_attack")
        tally = chk_attack.new_tally()
        out = eval_attack.check_attack_records(cell, base.seed, base.device, attack_calls,
                                               self.sample, base.batch_inputs,
                                               base.attack_generator, tally=tally)
        extra = chk.check_defense(cell, base.seed, base.device, self.records, base.batch_inputs,
                                  self.cal_calls, self.threshold, self.levels, tally)
        out.update(extra)
        out.update({k: v for k, v in chk_attack.readings(tally).items() if k.startswith("logit")})
        return out
