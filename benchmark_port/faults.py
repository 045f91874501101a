"""Faults planted under the timed path, to show that the check catches them
and to read the numbers they give: ``plant(name)`` replaces one function of
the program in this process (``setter`` is ``setattr`` or a test's
monkeypatch).  Used by the CPU tests and by ``readings.py --fault``.

Each fault breaks the program the way the contract lists: a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced.  The cells run on one card, so no exchange between
cards can be left out.
"""

from __future__ import annotations

import importlib

PORT = "image_recognition_adversarial_example_attack_tpu_torch"


def _module(name):
    return importlib.import_module(f"{PORT}.{name}")


def _unchanged_step(real):
    return lambda x_adv, grad, x_orig, eps, alpha: x_adv


def _half_attacked(real):
    def step(x_adv, grad, x_orig, eps, alpha):
        out = real(x_adv, grad, x_orig, eps, alpha).clone()
        half = x_adv.shape[0] // 2
        out[half:] = x_adv[half:]
        return out
    return step


def _one_element_moved(real):
    def step(x_adv, grad, x_orig, eps, alpha):
        out = real(x_adv, grad, x_orig, eps, alpha).clone()
        out.view(-1)[7] = 0.5 * (out.view(-1)[7] + x_adv.view(-1)[7]) + 1e-3
        return out
    return step


def _altered_logits(real):
    def make(*args, **kwargs):
        fn = real(*args, **kwargs)

        def altered(x):
            z = fn(x).clone()
            z[0, 0] += 3.0
            return z
        return altered
    return make


def _no_quantize(real):
    return lambda x, levels: x


def _score_altered(real):
    return lambda feats: real(feats) + 100.0


def _adam_unchanged(real):
    return lambda self, grads, state, params: (params, state)


def _train_half_batch(real):
    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(state, x, y, generator):
            n = x.shape[0] // 2
            return step(state, x[:n], y[:n], generator)
        return half
    return make


def _loss_scaled(real):
    return lambda *args: 1.5 * real(*args)


# name -> (module of the program, attribute, the fault made from the real one)
FAULTS = {
    "step_unchanged": ("kernels.elementwise", "pgd_step", _unchanged_step),
    "half_batch_unattacked": ("kernels.elementwise", "pgd_step", _half_attacked),
    "x_adv_altered": ("kernels.elementwise", "pgd_step", _one_element_moved),
    "logits_altered": ("attacks.api", "make_logits_fn", _altered_logits),
    "defense_skipped": ("defenses.preprocess", "quantize", _no_quantize),
    "detector_score_altered": ("eval.defense_eval", "score_from_features", _score_altered),
    "train_state_unchanged": ("train.optim", "AdamW.update", _adam_unchanged),
    "train_half_batch": ("train.adversarial", "make_train_step", _train_half_batch),
    "train_loss_altered": ("train.adversarial", "_ce_loss", _loss_scaled),
}


def plant(name: str, setter=setattr) -> None:
    module, attr, make = FAULTS[name]
    target = _module(module)
    *owners, leaf = attr.split(".")
    for o in owners:
        target = getattr(target, o)
    setter(target, leaf, make(getattr(target, leaf)))
