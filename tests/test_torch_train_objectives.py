"""The port's training objectives beyond plain PGD-AT (train/adversarial.py)
against the JAX package's on the CPU: SmoothAdv and Cohen's noise training,
free-AT, TRADES, MART, IBP and CROWN-IBP.

``wrn_tiny`` (``ibp_tiny`` for the certified objectives) trains from the
same float64 variables in both packages, the port's state carried from
the JAX state by ``train_state_from_jax``, JAX's draws fed through the
port's draw functions (the PGD start, TRADES's normal, Cohen's noise, the
EOT seed and noise, the augmentation), both packages' float32 casts
lifted (``_torch_train_helpers.lifted_casts``).  Parameters, moments,
metrics (and free-AT's carried perturbation) after 2-3 steps agree within
``TOL64 = 1e-9`` (absolute; parameters of order 1, learning rate 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_helpers as H
from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.train import adversarial as jax_adv
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise
from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

TOL64 = 1e-9
B = 4
BASE = dict(eps=0.03, alpha=0.01, attack_steps=2, learning_rate=1e-2, weight_decay=1e-2)
# case -> (objective, config)
CASES = {
    "smoothadv": ("pgd-at", dict(noise_sigma=0.1, noise_samples=3)),
    "cohen": ("pgd-at", dict(noise_sigma=0.1, attack_steps=0)),
    "trades": ("trades", dict(trades_beta=3.0)),
    "trades+accum": ("trades", dict(grad_accum=2, ema_decay=0.6)),
    "mart": ("mart", dict(mart_beta=4.0)),
    "mart+cutout": ("mart", dict(aug_cutout=8, label_smoothing=0.1)),
}
MAKE = {"pgd-at": "make_train_step", "trades": "make_trades_step", "mart": "make_mart_step"}


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(12)
    x = rs.uniform(0.05, 0.95, (B, 32, 32, 3))
    return x, np.array([3, 0, 9, 5]), H.variables("wrn_tiny"), H.variables("ibp_tiny", seed=4)


def _compare(state, m, js, jm, name="wrn_tiny"):
    assert state.step == int(js.step)
    for ours, theirs in ((state.params, js.params), (state.opt_state.mu, js.opt_state[0].mu),
                         (state.opt_state.nu, js.opt_state[0].nu)):
        assert H.max_diff(ours, theirs, name) < TOL64
    if js.ema_params is not None:
        assert H.max_diff(state.ema_params, js.ema_params, name) < TOL64
    assert set(m) == set(jm)
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) < TOL64, (k, float(m[k]), float(jm[k]))


def _run(objective, kw, x, y, var, keys, monkeypatch, name="wrn_tiny", spec=False):
    """Both packages through ``keys`` steps; the comparisons after each."""
    mean, std = H.stats(name)
    jcfg, pcfg = jax_adv.AdvTrainConfig(**kw), adversarial.AdvTrainConfig(**kw)
    with H.lifted_casts():
        with jax.enable_x64():
            jstate = jax_adv.train_state_from_bundle(H.jax_bundle(name, var), jcfg)
            if spec:
                jstep = jax.jit(jax_adv.make_ibp_step(jcfg, H.jax_module(name).spec, mean, std))
            else:
                jstep = jax.jit(getattr(jax_adv, MAKE[objective])(jcfg, mean, std))
        template = adversarial.train_state_from_bundle(H.port_bundle(name, var), pcfg)
        state = H.carry(template, jstate, name)
        pstep = (adversarial.make_ibp_step(pcfg, template.model.spec, mean, std) if spec
                 else getattr(adversarial, MAKE[objective])(pcfg, mean, std))
        feeder = H.Feeder(monkeypatch, n_eot=kw.get("noise_samples", 4))
        metrics = []
        for k in keys:
            with jax.enable_x64():
                jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), k)
            micro = (B // kw.get("grad_accum", 1), *x.shape[1:])
            feeder.add(H.step_draws(objective, jcfg, k, x.shape), micro)
            state, m = pstep(state, H.t(x), H.t(y), generator_from_seed(0))
            assert feeder.empty()
            _compare(state, m, jstate, jm, name)
            metrics.append(jm)
    return metrics


@pytest.mark.parametrize("case", list(CASES))
def test_objective_step_equals_jaxs(case, data, monkeypatch):
    x, y, var, _ = data
    objective, extra = CASES[case]
    kw = {**BASE, **extra}
    calls = []
    real = elementwise.pgd_step
    monkeypatch.setattr(elementwise, "pgd_step", lambda *a: calls.append(1) or real(*a))
    metrics = _run(objective, kw, x, y, var, [jax.random.PRNGKey(60 + i) for i in range(2)],
                   monkeypatch)
    # every inner update goes through the pgd_step wrapper (TRADES's too)
    assert len(calls) == 2 * kw["attack_steps"] * kw.get("grad_accum", 1)
    assert all(np.isfinite(float(v)) for m in metrics for v in m.values())


@pytest.mark.parametrize("kw", [dict(), dict(aug_pad=4, aug_flip=True, ema_decay=0.5)],
                         ids=["plain", "augment+ema"])
def test_free_step_equals_jaxs(kw, data, monkeypatch):
    """Two batches of free-AT (3 replays each), the perturbation carried."""
    x, y, var, _ = data
    kw = {**BASE, "free_replays": 3, **kw}
    jcfg, pcfg = jax_adv.AdvTrainConfig(**kw), adversarial.AdvTrainConfig(**kw)
    mean, std = H.stats("wrn_tiny")
    keys = [jax.random.PRNGKey(70), jax.random.PRNGKey(71)]
    with H.lifted_casts():
        with jax.enable_x64():
            jstate = jax_adv.train_state_from_bundle(H.jax_bundle("wrn_tiny", var), jcfg)
            jstep = jax.jit(jax_adv.make_free_step(jcfg, mean, std))
            jdelta = jnp.zeros(x.shape)
        state = H.carry(adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var), pcfg),
                        jstate)
        pstep = adversarial.make_free_step(pcfg, mean, std)
        delta = torch.zeros(x.shape, dtype=torch.float64)
        feeder = H.Feeder(monkeypatch)
        for k in keys:
            with jax.enable_x64():
                jstate, jm, jdelta = jstep(jstate, jnp.asarray(x), jnp.asarray(y), k, jdelta)
            feeder.add(H.step_draws("free", jcfg, k, x.shape))
            state, m, delta = pstep(state, H.t(x), H.t(y), generator_from_seed(0), delta)
            assert feeder.empty() and state.step == int(jstate.step)
            _compare(state, m, jstate, jm)
            assert float(torch.max(torch.abs(delta - H.t(jdelta)))) < TOL64
    assert state.step == 6 and 0 < float(torch.max(torch.abs(delta))) <= kw["eps"]


def test_free_step_refuses_grad_accum():
    for mod in (jax_adv, adversarial):
        with pytest.raises(ValueError, match="grad_accum does not compose"):
            mod.make_free_step(mod.AdvTrainConfig(grad_accum=2))


@pytest.mark.parametrize("kw", [
    dict(ibp_ramp_steps=2), dict(ibp_bound="crown", ibp_ramp_steps=2, ibp_final_beta=0.25),
    dict(ibp_bound="crown", remat=True, ibp_kappa=0.3, ema_decay=0.5)],
    ids=["ibp", "crown-ibp", "crown-ibp+remat+ema"])
def test_ibp_step_equals_jaxs(kw, data, monkeypatch):
    """IBP and CROWN-IBP on ibp_tiny (mean 0 / std 1) for 3 steps: the
    ramped eps and kappa (and beta) ride ``state.step``."""
    x, y, _, var = data
    kw = {**BASE, "eps": 0.01, **kw}
    metrics = _run("ibp", kw, x, y, var, [jax.random.PRNGKey(80 + i) for i in range(3)],
                   monkeypatch, name="ibp_tiny", spec=True)
    eps_t = [float(m["ibp_eps"]) for m in metrics]
    if kw.get("ibp_ramp_steps"):
        np.testing.assert_allclose(eps_t, [0.0, 0.005, 0.01], rtol=1e-6)
    else:
        assert eps_t == [pytest.approx(0.01)] * 3


def test_ibp_step_refuses_an_unknown_bound():
    for mod in (jax_adv, adversarial):
        with pytest.raises(ValueError, match="unknown ibp_bound 'lp'"):
            mod.make_ibp_step(mod.AdvTrainConfig(ibp_bound="lp"), ())
