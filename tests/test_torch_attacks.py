"""The port's FGSM and PGD against the JAX package's ``run_attack`` (CPU).

Both sides run resnet_tiny with the same (bridged) float64 weights, so a
sign() decision cannot flip on rounding noise: adversarial batches agree to
1e-9.  Both logits functions return float32, as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_NAMES, AttackParams, cross_entropy_sum, input_grad, make_logits_fn,
    run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

EPS, ALPHA = 8 / 255, 2 / 255


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        lf_jax = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        lf_port = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)
        x = np.random.RandomState(11).uniform(0.1, 0.9, size=(4, 32, 32, 3))
        y = np.asarray(jax.jit(lf_jax)(jnp.asarray(x))).argmax(-1)
    return lf_jax, lf_port, x, y


def test_logits_and_loss_match(setup):
    lf_jax, lf_port, x, y = setup
    want = np.asarray(lf_jax(jnp.asarray(x)))
    got = lf_port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1.2e-7, atol=0)
    logits = np.random.RandomState(0).randn(5, 7)
    yy = np.array([0, 3, 6, 2, 2])
    np.testing.assert_allclose(
        float(cross_entropy_sum(torch.from_numpy(logits), torch.from_numpy(yy))),
        float(jax_api.cross_entropy_sum(jnp.asarray(logits), jnp.asarray(yy))),
        rtol=1e-13)


def test_input_grad_matches(setup):
    """The float32 logits make the loss float32 on both sides, whose
    reductions round in another order: relative 1e-5."""
    lf_jax, lf_port, x, y = setup
    want = np.asarray(jax.jit(lambda xx, yy: jax_api.input_grad(lf_jax, xx, yy))(
        jnp.asarray(x), jnp.asarray(y)))
    got = input_grad(lf_port, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the same signs: what FGSM and PGD read
    assert np.array_equal(np.sign(got), np.sign(want))


@pytest.mark.parametrize("attack", ["fgsm", "pgd"])
@pytest.mark.parametrize("targeted", [False, True])
def test_attack_matches_jax(setup, attack, targeted):
    lf_jax, lf_port, x, y = setup
    y_t = (y + 1) % 10 if targeted else None
    want = np.asarray(jax.jit(lambda xx, yy, key: jax_api.run_attack(
        attack, lf_jax, xx, yy,
        jax_api.AttackParams(eps=EPS, alpha=ALPHA, steps=3, random_start=False),
        key, y_target=None if y_t is None else jnp.asarray(y_t)))(
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0)))
    got = run_attack(
        attack, lf_port, torch.from_numpy(x), torch.from_numpy(y),
        AttackParams(eps=EPS, alpha=ALPHA, steps=3, random_start=False),
        y_target=None if y_t is None else torch.from_numpy(y_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.abs(got - x).max() <= EPS + 1e-12
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(got - x).max() > 0.5 * EPS  # the attack moved the batch


def test_pgd_random_start_is_seeded_and_in_the_ball(setup):
    _, lf_port, x, y = setup
    xt, yt = torch.from_numpy(x).float(), torch.from_numpy(y)
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=2, random_start=True)

    def lf32(xx):
        return lf_port(xx.double())

    a = run_attack("pgd", lf32, xt, yt, params, generator_from_seed(3))
    b = run_attack("pgd", lf32, xt, yt, params, generator_from_seed(3))
    c = run_attack("pgd", lf32, xt, yt, params, generator_from_seed(4))
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float((a - xt).abs().max()) <= EPS + 1e-6
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_unported_attacks_raise():
    """The registry is the JAX package's, all 25 names in its order; a name
    outside it (``uap``, a module not ported yet) raises JAX's error."""
    assert ATTACK_NAMES == jax_api.ATTACK_NAMES and len(ATTACK_NAMES) == 25
    assert "uap" not in jax_api.ATTACK_NAMES
    with pytest.raises(ValueError, match="unknown attack 'uap'"):
        run_attack("uap", lambda x: x, torch.zeros(1, 2, 2, 3),
                   torch.zeros(1, dtype=torch.long), AttackParams())
    with pytest.raises(ValueError, match="unknown attack 'uap'"):
        jax_api.run_attack("uap", lambda x: x, None, None, jax_api.AttackParams())
