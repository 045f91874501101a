"""Adversarial training: per unit, one training step of the program on a
fresh batch made on the device, through the step that
``train.adversarial.make_train_step`` builds (Madry PGD-AT with the
traffic's ``AdvTrainConfig`` fields), on the state that
``train.adversarial.train_state_from_bundle`` built from the zoo's model in
float32 (the masters) with the benchmark's weights, computing in the
configuration's dtype.

Set-up builds the one state and drives it through the first steps (the
traffic's ``checked_steps``), through the window's own call on batches that
all differ; the check follows those steps with the reference.  The same
state then runs the window.
"""

from __future__ import annotations

import sys

import torch
from torch.profiler import record_function

SPAN = "pb."


class Job:
    kind = "train"

    def __init__(self, cell, seed: int, device, control: bool = False):
        from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
            AdvTrainConfig, make_train_step, train_state_from_bundle)

        self.cell, self.seed, self.device, self.control = cell, seed, device, control
        self.inputs = cell.piece("inputs")
        t, c = cell.traffic, cell.config
        self.batch, self.size, self.classes = int(t["batch"]), int(c["image_size"]), int(c["num_classes"])
        self.checked = int(t["checked_steps"])
        self.examples_per_unit = self.batch
        self.steps_per_unit = 1
        # PGD: a forward and an input-gradient chain a step; the update: a
        # forward, the input-gradient chain and the weight gradients
        self.forward_equivalents_per_unit = self.batch * (2 * int(t["attack_steps"]) + 3)
        self.work = {"attack_numel": self.batch * self.size * self.size * 3}
        self.losses, self.first_grad, self.after = [], None, None
        if control:  # the control is the reference's own, in a lower precision
            self.state = self.step = None
            return
        eval_attack = cell.piece("drivers/eval_attack")
        bundle = eval_attack.load_program(cell, seed, device, torch.float32)
        self.config = AdvTrainConfig(eps=float(t["eps"]), alpha=float(t["alpha"]),
                                     attack_steps=int(t["attack_steps"]),
                                     learning_rate=float(t["learning_rate"]),
                                     weight_decay=float(t["weight_decay"]))
        self.state = train_state_from_bundle(bundle, self.config, getattr(torch, c["dtype"]))
        self.step = make_train_step(self.config, bundle.mean, bundle.std)

    def batch_inputs(self, index):
        return self.inputs.make_batch(self.seed, index, self.batch, self.size, self.classes,
                                      self.device)

    def step_generator(self, index):
        return self.inputs.host_generator(self.seed, "train", index)

    def _step(self, index):
        with record_function(SPAN + "inputs"):
            x, y = self.batch_inputs(index)
        with record_function(SPAN + "train_step"):
            self.state, metrics = self.step(self.state, x, y, self.step_generator(index))
        return metrics

    def warm_up(self):
        """The checked steps: the first moment after the first, each loss,
        and the parameters after the last (kept before the window moves on)."""
        if self.control:
            return
        for k in range(self.checked):
            metrics = self._step(f"checked {k}")
            self.losses.append(metrics["loss"].detach().clone())
            if k == 0:
                self.first_grad = {n: m / (1 - 0.9) for n, m in self.state.opt_state.mu.items()}
        self.after = dict(self.state.params)

    run_sampled = warm_up

    def unit(self, index: int):
        self._step(index)

    def free(self):
        self.state = self.step = None

    def check(self) -> dict:
        ref = self.cell.piece(f"reference/{self.cell.config['reference']}")
        plain = self.cell.piece("reference/plain_kernels")
        chk = self.cell.piece("reference/check_train")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        spec = ref.param_spec(self.cell.config)
        sd0 = self.inputs.make_weights(spec, ref.POSITIVE, self.seed, self.device)
        trained = [n for n, *_ in spec if not n.endswith(
            (".running_mean", ".running_var", ".num_batches_tracked"))]
        batches = []
        for k in range(self.checked):
            x, y = self.batch_inputs(f"checked {k}")
            # the step splits its generator in three: attack, EOT, noise
            batches.append((x, y, plain.split(self.step_generator(f"checked {k}"), 3)[0]))
        block = int(self.cell.traffic.get("check_block", 64))
        ref_run = chk.run_steps(ref.forward, sd0, trained, self.cell.config, batches, plain,
                                self.cell.traffic, self.device, block=block)
        if self.control:
            program = chk.run_steps(ref.forward, sd0, trained, self.cell.config, batches, plain,
                                    self.cell.traffic, self.device, cast=chk.fp8_cast,
                                    block=block)
        else:
            program = ([float(v) for v in self.losses], self.first_grad, self.after)
        values, left_out = chk.compare(*program, *ref_run, sd0)
        print(f"leaves left out of the gaps of norms: {len(left_out)} {left_out[:8]}",
              file=sys.stderr)
        return values
