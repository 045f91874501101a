"""Evaluation under a white-box attack: per unit, one fresh batch made on the
device, the attack through ``attacks.api.run_attack`` and the robust
prediction through ``attacks.api.predict_labels``, both on the model that
``models.zoo.load_model`` built and ``attacks.api.make_logits_fn`` wraps.

The traffic file gives the attack's name and parameters, the batch, the
number of warm-up batches, how many window batches the check samples (drawn
from the seed among the first ``sample_from``) and the rate metric.  The
model gets the benchmark's own weights, made on the device from the seed,
through ``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

SPAN = "pb."


class Recorder:
    """A logits function that keeps, between ``start`` and ``stop``, a copy of
    each call's input and output.  Copies go into spare buffers where one of
    the shape is left (``recycle``), so that recording in the window
    allocates nothing: the warm-up records once and recycles its copies."""

    def __init__(self, fn):
        self.fn, self.calls, self.spare = fn, None, []

    def __call__(self, x):
        out = self.fn(x)
        if self.calls is not None:
            self.calls.append((self._copy(x), self._copy(out)))
        return out

    def _copy(self, t):
        t = t.detach()
        for i, buf in enumerate(self.spare):
            if buf.shape == t.shape and buf.dtype == t.dtype:
                return self.spare.pop(i).copy_(t)
        return t.clone()

    def start(self):
        self.calls = []

    def stop(self) -> list:
        calls, self.calls = self.calls, None
        return calls

    def recycle(self, calls) -> None:
        self.spare.extend(t for pair in calls for t in pair)


def load_program(cell, seed: int, device, dtype, int8: bool = False):
    """The zoo's model bundle, carrying the benchmark's weights."""
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

    ref = cell.piece(f"reference/{cell.config['reference']}")
    inputs = cell.piece("inputs")
    bundle = load_model(cell.config["zoo_name"], dtype=dtype, device=device, int8=int8)
    weights = inputs.make_weights(ref.param_spec(cell.config), ref.POSITIVE, seed, device)
    bundle.model.load_state_dict(weights, strict=True)
    return bundle


def sample_indices(cell, seed: int) -> list[int]:
    """The window batches whose outputs the check compares, from the seed."""
    t = cell.traffic
    g = cell.piece("inputs").host_generator(seed, "sample")
    return sorted(torch.randperm(int(t["sample_from"]), generator=g)[:int(t["sample_batches"])]
                  .tolist())


class Job:
    kind = "eval"

    def __init__(self, cell, seed: int, device, control: bool = False):
        from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import (
            AttackParams, make_logits_fn)

        self.cell, self.seed, self.device = cell, seed, device
        self.inputs = cell.piece("inputs")
        t, c = cell.traffic, cell.config
        self.batch, self.size, self.classes = int(t["batch"]), int(c["image_size"]), int(c["num_classes"])
        dtype = getattr(torch, c["dtype"])
        # the control: the program's own int8 path, one precision below bf16
        self.bundle = load_program(cell, seed, device, dtype, int8=control)
        b = self.bundle
        self.logits_fn = Recorder(make_logits_fn(b.model, b.mean, b.std, input_dtype=dtype))
        self.params = AttackParams(eps=float(t["eps"]), alpha=float(t["alpha"]),
                                   steps=int(t["steps"]), random_start=bool(t["random_start"]))
        self.examples_per_unit = self.batch
        self.steps_per_unit = int(t["steps"])
        # each step a forward and an input-gradient chain, then one forward
        self.forward_equivalents_per_unit = self.batch * (2 * int(t["steps"]) + 1)
        self.work = {"attack_numel": self.batch * self.size * self.size * 3}
        self.sample = sample_indices(cell, seed)
        self.records: dict[int, list] = {}
        # the job's answer, robust accuracy, is summed on the card each unit
        self.robust = torch.zeros((), dtype=torch.int64, device=device)

    def batch_inputs(self, index):
        return self.inputs.make_batch(self.seed, index, self.batch, self.size, self.classes,
                                      self.device)

    def attack_generator(self, index):
        return self.inputs.host_generator(self.seed, "attack", index)

    def warm_up(self):
        for w in range(int(self.cell.traffic["warmup_batches"])):
            self.logits_fn.start()
            self._run(f"warm-up {w}")
            self.logits_fn.recycle(self.logits_fn.stop())

    def run_sampled(self):
        """Only the units that the check compares (for readings)."""
        for i in self.sample:
            self.unit(i)

    def unit(self, index: int):
        record = index in self.sample
        if record:
            self.logits_fn.start()
        self._run(index)
        if record:
            self.records[index] = self.logits_fn.stop()

    def _run(self, index):
        from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import (
            predict_labels, run_attack)

        with record_function(SPAN + "inputs"):
            x, y = self.batch_inputs(index)
        with record_function(SPAN + "attack"):
            x_adv = run_attack(self.cell.traffic["attack"], self.logits_fn, x, y, self.params,
                               self.attack_generator(index))
        with record_function(SPAN + "predict"):
            pred = predict_labels(self.logits_fn, x_adv)
        self.robust += (pred == y).sum()

    def free(self):
        self.logits_fn = self.bundle = None

    def check(self) -> dict:
        return check_attack_records(self.cell, self.seed, self.device, self.records, self.sample,
                                    self.batch_inputs, self.attack_generator)


def check_attack_records(cell, seed, device, records, sample, batch_inputs, attack_generator,
                         tally=None) -> dict:
    """The reference's readings of the sampled batches."""
    ref = cell.piece(f"reference/{cell.config['reference']}")
    plain = cell.piece("reference/plain_kernels")
    chk = cell.piece("reference/check_attack")
    t = cell.traffic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = cell.piece("inputs").make_weights(ref.param_spec(cell.config), ref.POSITIVE, seed, device)
    logits_fn = chk.make_logits_fn(ref.forward, sd, cell.config, device)
    tally = chk.new_tally() if tally is None else tally
    missing = [i for i in sample if i not in records]
    for i in sample:
        if i not in records:
            continue
        x, y = batch_inputs(i)
        noise = plain.start_noise(x.shape, float(t["eps"]), attack_generator(i), device)
        chk.check_pgd(tally, logits_fn, plain, x, y, records[i], noise, float(t["eps"]),
                      float(t["alpha"]), int(t["steps"]), block=int(t.get("check_block", 64)))
    values = chk.readings(tally)
    values["batches_missing"] = float(len(missing))
    return values
