"""Registry-driven invariants of the port's attack zoo (the counterpart of
``tests/test_zoo_invariants.py``).

One sweep over every name in the port's ``ATTACK_THREAT`` through
``run_attack`` on resnet_tiny (CPU, float32): the shape and dtype, the
[0,1] range, the threat model's bound (``|x_adv - x|_inf <= eps + 1e-6``
for ``linf``, the L2 and L1 norms of the delta for ``l2`` and ``l1``, the
changed-pixel count for ``l0``) and determinism under the same generator.  The
parametrization is the registry itself, so an attack cannot land in the
dispatch without a threat model and without passing here.
"""

import numpy as np
import pytest
import torch

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_NAMES, ATTACK_THREAT, AttackParams, make_logits_fn, predict_labels, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

EPS = 8 / 255
# the sweep checks invariants, not strength: the JAX sweep's tiny budgets
# (tests/test_zoo_invariants.py), a few steps each
SWEEP_PARAMS = AttackParams(
    eps=EPS, alpha=2 / 255, steps=3, cw_steps=5, square_steps=8, deepfool_steps=3,
    deepfool_classes=4, est_samples=4, bandits_steps=6, bandits_prior_factor=4, hsja_steps=2,
    hsja_probes=4, n_target_classes=3, stadv_steps=4, boundary_steps=8, simba_steps=8,
    jsma_steps=5, spatial_candidates=3)


@pytest.fixture(scope="module")
def sweep_inputs():
    bundle = zoo.load_model("resnet_tiny", device="cpu")
    logits_fn = make_logits_fn(bundle.model, bundle.mean, bundle.std)
    x = torch.from_numpy(np.random.RandomState(7).uniform(0.2, 0.8, (3, 32, 32, 3))
                         .astype(np.float32))
    return logits_fn, x, predict_labels(logits_fn, x)


def test_registry_is_the_dispatch_surface():
    assert set(ATTACK_NAMES) == set(ATTACK_THREAT)
    assert set(ATTACK_THREAT.values()) <= {"linf", "l2", "l1", "l0", "none"}
    # every ported attack keeps the JAX registry's threat model
    assert all(jax_api.ATTACK_THREAT[n] == t for n, t in ATTACK_THREAT.items())


@pytest.mark.parametrize("name", sorted(ATTACK_THREAT))
def test_zoo_member_invariants(name, sweep_inputs):
    logits_fn, x, y = sweep_inputs
    a = run_attack(name, logits_fn, x, y, SWEEP_PARAMS, generator_from_seed(0))
    b = run_attack(name, logits_fn, x, y, SWEEP_PARAMS, generator_from_seed(0))
    assert a.shape == x.shape and a.dtype == x.dtype
    assert bool(torch.isfinite(a).all())
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert torch.equal(a, b), "not deterministic under the same generator"
    threat = ATTACK_THREAT[name]
    delta = (a - x).reshape(x.shape[0], -1)
    if threat == "linf":
        assert float(delta.abs().max()) <= EPS + 1e-6
    elif threat == "l2":
        assert float(delta.norm(dim=1).max()) <= EPS + 1e-4
    elif threat == "l1":
        assert float(delta.abs().sum(dim=1).max()) <= EPS + 1e-4
    elif threat == "l0":
        # jsma moves at most one feature a step: at most jsma_steps pixels
        changed = (delta.reshape(x.shape[0], -1, 3) != 0).any(dim=-1).sum(dim=-1)
        assert int(changed.max()) <= SWEEP_PARAMS.jsma_steps
    else:
        assert threat == "none"
