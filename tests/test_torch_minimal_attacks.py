"""DeepFool, EAD and JSMA of the port (attacks/deepfool.py, ead.py,
jsma.py) against the JAX package's on the CPU.

Both sides attack resnet_tiny with the same float64 weights and float64
logits (the uncast closures of ``_torch_port_helpers``), four 32x32 images,
a few steps; none of the three draws anything.  The adversarial batches
agree within 1e-9.  DeepFool's k candidate gradients are k backward passes
of one forward in the port and one vmapped vjp in JAX; JSMA's two
gradients are two backward passes of one forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import deepfool as jax_deepfool
from image_recognition_adversarial_example_attack_tpu.attacks import ead as jax_ead
from image_recognition_adversarial_example_attack_tpu.attacks import jsma as jax_jsma
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_THREAT, AttackParams, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import deepfool, ead, jsma
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

TOL = 1e-9


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(41).uniform(0.05, 0.95, size=(4, 32, 32, 3))
        x[0, :4, :4] = 1.0  # saturated features: JSMA's room-to-move checks
        x[1, :4, :4] = 0.0
        y = np.asarray(jax.jit(fns["jax"][0])(jnp.asarray(x))).argmax(-1)
    return fns["jax"][0], fns["port"][0], x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, x):
    with jax.enable_x64():
        return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.mark.parametrize("k,overshoot", [(4, 0.02), (10, 0.3)])
def test_deepfool_equals_jaxs(setup, k, overshoot):
    lf_jax, lf_port, x, y = setup
    want = _jax(lambda xx: jax_deepfool.deepfool_attack(
        lf_jax, xx, steps=6, num_classes=k, overshoot=overshoot), x)
    got = deepfool.deepfool_attack(lf_port, _t(x), _t(y), steps=6, num_classes=k,
                                   overshoot=overshoot).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0
    with torch.no_grad():
        fooled = lf_port(_t(got)).argmax(-1).numpy() != y
    assert fooled.any()  # the attack reached a boundary somewhere


def test_deepfool_candidates_keep_the_lower_index_of_a_tie():
    """``lax.top_k`` breaks a tie toward the lower index: so does the port's
    stable descending sort (classes 1 and 3 tie for the top; 1 is k0)."""
    logits = torch.tensor([[0.0, 2.0, 1.0, 2.0]])

    def lf(z):
        return logits + 0.0 * z.sum()

    # a model whose gradient is zero: no step, but the candidates are fixed
    out = deepfool.deepfool_attack(lf, torch.full((1, 2, 2, 3), 0.5), steps=1, num_classes=3)
    assert torch.equal(out, torch.full((1, 2, 2, 3), 0.5))
    _, idx = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(
        torch.argsort(-logits, dim=-1, stable=True)[:, :3].numpy(), np.asarray(idx))


@pytest.mark.parametrize("targeted", [False, True])
def test_ead_equals_jaxs(setup, targeted):
    lf_jax, lf_port, x, y = setup
    y_t = (y + 3) % 10 if targeted else None
    kw = dict(c=50.0, kappa=0.0, beta=1e-3, steps=6, lr=0.05, targeted=targeted)
    with jax.enable_x64():
        res = jax.jit(lambda xx: jax_ead.ead_attack(
            lf_jax, xx, jnp.asarray(y), y_target=None if y_t is None else jnp.asarray(y_t),
            **kw))(jnp.asarray(x))
    got = ead.ead_attack(lf_port, _t(x), _t(y), y_target=None if y_t is None else _t(y_t), **kw)
    np.testing.assert_allclose(got.x_adv.numpy(), np.asarray(res.x_adv), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(res.success))
    assert np.abs(got.x_adv.numpy() - x).max() > 0.01


def test_ead_shrink_equals_jaxs():
    rs = np.random.RandomState(2)
    z, x0 = rs.uniform(-0.2, 1.2, (3, 5, 5, 3)), rs.uniform(0, 1, (3, 5, 5, 3))
    z[0, 0, 0] = x0[0, 0, 0] + 0.01  # exactly beta away
    with jax.enable_x64():
        want = np.asarray(jax_ead._shrink(jnp.asarray(z), jnp.asarray(x0), 0.01))
    np.testing.assert_array_equal(ead._shrink(_t(z), _t(x0), 0.01).numpy(), want)


@pytest.mark.parametrize("targeted", [False, True])
def test_jsma_equals_jaxs(setup, targeted):
    lf_jax, lf_port, x, y = setup
    y_t = (y + 3) % 10 if targeted else None
    steps = 8
    want = _jax(lambda xx: jax_jsma.jsma_attack(
        lf_jax, xx, jnp.asarray(y), steps=steps, theta=1.0,
        y_target=None if y_t is None else jnp.asarray(y_t)), x)
    got = jsma.jsma_attack(lf_port, _t(x), _t(y), steps=steps, theta=1.0,
                           y_target=None if y_t is None else _t(y_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    changed = (got != x).reshape(4, -1).sum(-1)
    assert (changed <= steps).all() and changed.max() > 0


def test_jsma_with_no_admissible_feature_changes_nothing():
    """A model with zero gradients: both saliency maxima are 0, both argmaxes
    index 0, go_up holds, and no feature moves."""
    x = torch.full((2, 3, 3, 3), 0.5)

    def lf(z):
        return torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5]]) + 0.0 * z.sum()

    out = jsma.jsma_attack(lf, x, torch.tensor([0, 1]), steps=3)
    assert torch.equal(out, x)


@pytest.mark.parametrize("name", ["deepfool", "ead", "jsma"])
def test_run_attack_dispatch_equals_jaxs(setup, name):
    """Through ``run_attack`` with the JAX dataclass's field names: deepfool's
    own budgets, ead's ``cw_steps``/``cw_kappa`` with ``ead_*``, jsma's."""
    lf_jax, lf_port, x, y = setup
    kw = dict(deepfool_steps=3, deepfool_classes=3, cw_steps=4, ead_c=20.0, jsma_steps=4)
    want = _jax(lambda xx: jax_api.run_attack(name, lf_jax, xx, jnp.asarray(y),
                                              jax_api.AttackParams(**kw)), x)
    got = run_attack(name, lf_port, _t(x), _t(y), AttackParams(**kw),
                     generator_from_seed(0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert ATTACK_THREAT[name] == jax_api.ATTACK_THREAT[name]


def test_deepfool_refuses_a_target():
    with pytest.raises(ValueError, match="untargeted-only"):
        run_attack("deepfool", lambda z: z.sum((1, 2)), torch.zeros(1, 4, 4, 3),
                   torch.zeros(1, dtype=torch.long), AttackParams(),
                   y_target=torch.ones(1, dtype=torch.long))
