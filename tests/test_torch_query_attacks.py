"""The port's query-based black-box attacks (attacks/grad_est.py, bandits.py,
simba.py, hsja.py, boundary.py) against the JAX package's on the CPU.

Float64 resnet_tiny, four 32x32 images, small budgets; JAX's own draws for
the key are fed through each module's draw function (``draw_probe``,
``draw_latent``, ``draw_simba``, ``draw_init``, ``draw_direction``,
``draw_eta``), so results and success histories agree within 1e-9.  The
helpers (``_upsample``, ``_eg_step``, ``dct_basis_image``) are held
directly, and ``run_attack`` passes each attack's budget as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_blackbox_helpers import (TOL, bandits_draws, boundary_draws, constant, feed,
                                     hsja_draws, make_setup, probe_draws, run_jax, simba_draws,
                                     t)
from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import bandits as jax_bandits
from image_recognition_adversarial_example_attack_tpu.attacks import boundary as jax_boundary
from image_recognition_adversarial_example_attack_tpu.attacks import grad_est as jax_grad_est
from image_recognition_adversarial_example_attack_tpu.attacks import hsja as jax_hsja
from image_recognition_adversarial_example_attack_tpu.attacks import simba as jax_simba
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_THREAT, AttackParams, bandits, boundary, grad_est, hsja, run_attack, simba)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

EPS, ALPHA = 8 / 255, 2 / 255


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def decision_setup():
    """Weights whose decisions vary over the images and over noise (labels
    1 and 2, noise 0, 1 or 2), so the decision-based attacks find starts;
    the other set's model gives one class almost everywhere."""
    return make_setup(seed=1)


def _gen():
    return generator_from_seed(0)


@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("name", ["nes", "spsa"])
def test_grad_est_equals_jaxs(setup, name, targeted, monkeypatch):
    """3 steps of 4 antithetic probe pairs, with the success history."""
    lf_jax, lf_port, x, y = setup
    key, steps, n = jax.random.PRNGKey(3), 3, 4
    sampler = "gaussian" if name == "nes" else "rademacher"
    monkeypatch.setattr(grad_est, "draw_probe", feed(probe_draws(key, steps, n, x.shape, sampler)))
    y_t = (y + 3) % 10 if targeted else None
    # radii that move a float64 loss well past its rounding
    kw = {"sigma": 1e-2} if name == "nes" else {"delta": 5e-2}
    jax_fn = getattr(jax_grad_est, f"{name}_attack")
    want_x, want_h = run_jax(lambda xx: jax_fn(
        lf_jax, xx, jnp.asarray(y), eps=EPS, alpha=ALPHA, steps=steps, key=key, n_samples=n,
        y_target=None if y_t is None else jnp.asarray(y_t), return_history=True, **kw), x)
    got_x, got_h = getattr(grad_est, f"{name}_attack")(
        lf_port, t(x), t(y), eps=EPS, alpha=ALPHA, steps=steps, generator=_gen(), n_samples=n,
        y_target=None if y_t is None else t(y_t), return_history=True, **kw)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert np.abs(got_x.numpy() - x).max() <= EPS + 1e-12
    assert np.abs(got_x.numpy() - x).max() > EPS / 2


def test_upsample_and_eg_step_equal_jaxs():
    rs = np.random.RandomState(4)
    v = rs.uniform(-1, 1, (3, 4, 4, 3))
    with jax.enable_x64():
        want_up = np.asarray(jax_bandits._upsample(jnp.asarray(v), 32, 32))
        want_up_odd = np.asarray(jax_bandits._upsample(jnp.asarray(v), 13, 9))
        g = rs.randn(*v.shape) * 50.0
        v_edge = v.copy()
        v_edge[0, 0, 0] = [1.0, -1.0, 0.0]
        want_eg = np.asarray(jax_bandits._eg_step(jnp.asarray(v_edge), jnp.asarray(g), 0.7))
    np.testing.assert_allclose(bandits._upsample(t(v), 32, 32).numpy(), want_up, rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(bandits._upsample(t(v), 13, 9).numpy(), want_up_odd, rtol=0,
                               atol=1e-14)
    got_eg = bandits._eg_step(t(v_edge), t(g), 0.7).numpy()
    np.testing.assert_allclose(got_eg, want_eg, rtol=0, atol=1e-14)
    assert np.abs(got_eg).max() < 1.0


@pytest.mark.parametrize("targeted", [False, True])
def test_bandits_equals_jaxs(setup, targeted, monkeypatch):
    """6 steps on a 4x4 latent lattice (prior factor 8 at 32x32)."""
    lf_jax, lf_port, x, y = setup
    key, steps = jax.random.PRNGKey(5), 6
    monkeypatch.setattr(bandits, "draw_latent", feed(bandits_draws(key, steps, (4, 4, 4, 3))))
    y_t = (y + 1) % 10 if targeted else None
    want_x, want_h = run_jax(lambda xx: jax_bandits.bandits_attack(
        lf_jax, xx, jnp.asarray(y), eps=EPS, alpha=ALPHA, steps=steps, key=key,
        y_target=None if y_t is None else jnp.asarray(y_t), return_history=True), x)
    got_x, got_h = bandits.bandits_attack(
        lf_port, t(x), t(y), eps=EPS, alpha=ALPHA, steps=steps, generator=_gen(),
        y_target=None if y_t is None else t(y_t), return_history=True)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert np.abs(got_x.numpy() - x).max() <= EPS + 1e-12


def test_bandits_refuses_what_jax_refuses():
    x, y = torch.zeros(1, 8, 8, 3), torch.zeros(1, dtype=torch.long)
    for kw, match in (({"prior_factor": 0}, "prior_factor must be >= 1"),
                      ({"fd_eta": 0.0}, "must be > 0"), ({"delta": -1.0}, "must be > 0")):
        with pytest.raises(ValueError, match=match):
            bandits.bandits_attack(lambda z: z.sum((1, 2)), x, y, eps=EPS, alpha=ALPHA, steps=1,
                                   generator=_gen(), **kw)


def test_dct_basis_images_equal_jaxs_and_are_orthonormal():
    us, vs = np.array([0, 0, 3, 7, 1]), np.array([0, 5, 0, 2, 1])
    got = simba.dct_basis_image(torch.from_numpy(us), torch.from_numpy(vs), 12, 9,
                                torch.float64).numpy()
    with jax.enable_x64():
        want = np.stack([np.asarray(jax_simba.dct_basis_image(u, v, 12, 9, jnp.float64))
                         for u, v in zip(us, vs)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    with jax.enable_x64():
        want_one = np.asarray(jax_simba.dct_basis_image(3, 2, 12, 9, jnp.float64))
    np.testing.assert_allclose(simba.dct_basis_image(3, 2, 12, 9, torch.float64).numpy(),
                               want_one, rtol=0, atol=1e-15)
    flat = got.reshape(5, -1)
    np.testing.assert_allclose(flat @ flat.T, np.eye(5), atol=1e-12)


@pytest.mark.parametrize("mode", ["dct", "pixel"])
def test_simba_equals_jaxs(setup, mode, monkeypatch):
    """10 steps; one sample starts misclassified (its label moved), so it
    must stay untouched."""
    lf_jax, lf_port, x, y = setup
    y = y.copy()
    y[2] = (y[2] + 1) % 10
    key, steps = jax.random.PRNGKey(6), 10
    fh = 4 if mode == "dct" else 32
    monkeypatch.setattr(simba, "draw_simba", constant(simba_draws(key, steps, 4, fh, fh, 3)))
    want_x, want_h = run_jax(lambda xx: jax_simba.simba_attack(
        lf_jax, xx, jnp.asarray(y), steps=steps, eps=0.2, mode=mode, key=key,
        return_history=True), x)
    got_x, got_h = simba.simba_attack(lf_port, t(x), t(y), steps=steps, eps=0.2, mode=mode,
                                      generator=_gen(), return_history=True)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_x.numpy()[2], x[2])
    assert got_h[:, 2].all()
    assert np.abs(got_x.numpy() - x).max() > 0.0
    with pytest.raises(ValueError, match="unknown simba mode"):
        simba.simba_attack(lf_port, t(x), t(y), steps=1, mode="dst", generator=_gen())


@pytest.mark.parametrize("warm", [False, True])
def test_hsja_equals_jaxs(decision_setup, warm, monkeypatch):
    """2 iterations of 8 probes and 6 bisections (bisection walks onto the
    boundary, where more would leave only rounding between the sides);
    without ``x_init`` the 12 noise-blend starts, with it the warm start
    (the images rolled by one: misclassified where the labels differ)."""
    lf_jax, lf_port, x, y = decision_setup
    key, steps, probes, trials = jax.random.PRNGKey(7), 2, 8, 12
    inits, dirs = hsja_draws(key, steps, probes, trials, x.shape)
    monkeypatch.setattr(hsja, "draw_init", feed(inits))
    monkeypatch.setattr(hsja, "draw_direction", feed(dirs))
    x_init = np.roll(x, 1, axis=0) if warm else None
    kw = dict(steps=steps, n_probes=probes, bs_steps=6, init_trials=trials)
    if warm:
        want = run_jax(lambda xx, xi: jax_hsja.hsja_attack(
            lf_jax, xx, jnp.asarray(y), key=key, x_init=xi, **kw), x, x_init)
    else:
        want = run_jax(lambda xx: jax_hsja.hsja_attack(lf_jax, xx, jnp.asarray(y), key=key,
                                                       **kw), x)
    got = hsja.hsja_attack(lf_port, t(x), t(y), generator=_gen(),
                           x_init=None if x_init is None else t(x_init), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0
    moved = np.abs(got - x).reshape(4, -1).max(-1) > 0
    assert moved.any()


def test_boundary_equals_jaxs(decision_setup, monkeypatch):
    """20 walk steps from the noise-blend starts."""
    lf_jax, lf_port, x, y = decision_setup
    key, steps, trials = jax.random.PRNGKey(8), 20, 12
    inits, etas = boundary_draws(key, steps, trials, x.shape)
    monkeypatch.setattr(hsja, "draw_init", feed(inits))
    monkeypatch.setattr(boundary, "draw_eta", feed(etas))
    want = run_jax(lambda xx: jax_boundary.boundary_attack(
        lf_jax, xx, jnp.asarray(y), steps=steps, key=key, init_trials=trials), x)
    got = boundary.boundary_attack(lf_port, t(x), t(y), steps=steps, generator=_gen(),
                                   init_trials=trials).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert (np.abs(got - x).reshape(4, -1).max(-1) > 0).any()


@pytest.mark.parametrize("name", ["nes", "spsa", "bandits", "hsja", "boundary", "simba"])
def test_run_attack_dispatch_equals_jaxs(setup, decision_setup, name, monkeypatch):
    """Through ``run_attack``: each attack reads its budget fields as in
    JAX, and the threat models are JAX's."""
    lf_jax, lf_port, x, y = decision_setup if name in ("hsja", "boundary") else setup
    key = jax.random.PRNGKey(9)
    kw = dict(eps=EPS, steps=2, est_samples=2, nes_sigma=1e-2, spsa_delta=5e-2,
              bandits_steps=3, hsja_steps=1, hsja_probes=3, boundary_steps=4, simba_steps=4,
              simba_mode="pixel")
    if name in ("nes", "spsa"):
        sampler = "gaussian" if name == "nes" else "rademacher"
        monkeypatch.setattr(grad_est, "draw_probe", feed(probe_draws(key, 2, 2, x.shape,
                                                                     sampler)))
    elif name == "bandits":
        monkeypatch.setattr(bandits, "draw_latent", feed(bandits_draws(key, 3, (4, 4, 4, 3))))
    elif name == "hsja":
        inits, dirs = hsja_draws(key, 1, 3, 12, x.shape)
        monkeypatch.setattr(hsja, "draw_init", feed(inits))
        monkeypatch.setattr(hsja, "draw_direction", feed(dirs))
    elif name == "boundary":
        inits, etas = boundary_draws(key, 4, 12, x.shape)
        monkeypatch.setattr(hsja, "draw_init", feed(inits))
        monkeypatch.setattr(boundary, "draw_eta", feed(etas))
    else:
        monkeypatch.setattr(simba, "draw_simba", constant(simba_draws(key, 4, 4, 32, 32, 3)))
    want = run_jax(lambda xx: jax_api.run_attack(name, lf_jax, xx, jnp.asarray(y),
                                                 jax_api.AttackParams(**kw), key), x)
    got = run_attack(name, lf_port, t(x), t(y), AttackParams(**kw), _gen()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert ATTACK_THREAT[name] == jax_api.ATTACK_THREAT[name]


@pytest.mark.parametrize("name", ["square", "square_l2", "hsja", "boundary", "simba"])
def test_untargeted_only_black_box_attacks_refuse_a_target(name):
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="untargeted"):
        run_attack(name, lambda z: z.sum((1, 2)), x, torch.zeros(1, dtype=torch.long),
                   AttackParams(), y_target=torch.ones(1, dtype=torch.long))
