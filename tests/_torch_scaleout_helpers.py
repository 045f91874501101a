"""Shared set-up of the port's scale-out tests (tests/test_torch_sharding.py,
tests/test_torch_train_mesh.py, tests/test_torch_distributed.py and the
worker processes it starts, which import no JAX)."""

from __future__ import annotations

import numpy as np
import torch


def train_setup(**cfg_kw):
    """(step, state, x, y, generator) of one float64 PGD-AT step of
    wrn_tiny (seeded random weights) on 16 seeded 32x32 images."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.constants import (
        CIFAR10_MEAN, CIFAR10_STD)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        generator_from_seed)
    from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
    from image_recognition_adversarial_example_attack_tpu_torch.models.wideresnet import wrn_tiny
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    adversarial.LOSS_DTYPE = torch.float64
    model = zoo.random_init_(wrn_tiny()).double().requires_grad_(False).eval()
    bundle = zoo.ModelBundle(name="wrn_tiny", model=model, source="random", dtype=torch.float64,
                             device=torch.device("cpu"), mean=CIFAR10_MEAN.copy(),
                             std=CIFAR10_STD.copy(), input_size=32)
    cfg = adversarial.AdvTrainConfig(**{"attack_steps": 2, "learning_rate": 5e-3, **cfg_kw})
    rs = np.random.RandomState(4)
    x = rs.rand(16, 32, 32, 3)
    y = rs.randint(0, 10, 16)
    return (adversarial.make_train_step(cfg, CIFAR10_MEAN, CIFAR10_STD),
            adversarial.train_state_from_bundle(bundle, cfg), x, y, generator_from_seed(9))


def seeded_variables(model: torch.nn.Module, family: str, perturb, seed: int = 3) -> dict:
    """Flax variables (float64 numpy) of ``model`` after the port's seeded
    init (``zoo.random_init_``, Flax's distributions), carried through the
    converter and perturbed by ``perturb(tree, RandomState(seed))``: the
    same kind of tree as Flax's ``init``, without compiling it."""
    from image_recognition_adversarial_example_attack_tpu_torch.models import convert, zoo

    tree = convert.to_jax_variables(zoo.random_init_(model).double(), family)
    return perturb(tree, np.random.RandomState(seed))
