"""The port's training step (train/adversarial.py, train/optim.py) against
the JAX package's on the CPU: the schedules and AdamW against optax, PGD-AT
with its options (clean_weight, label smoothing, grad_accum, remat, EMA,
the cosine schedule), the eval steps and the checkpoints.

``wrn_tiny`` trains from the same float64 variables in both packages, the
port's state carried from the JAX state by ``train_state_from_jax``, with
JAX's draws fed through the port's draw functions
(``_torch_train_helpers``).  Tolerances:

- float64 with both packages' float32 casts lifted (``lifted_casts``):
  parameters, moments and metrics after 2-3 steps within ``TOL64 = 1e-9``
  (absolute; parameters are of order 1, the learning rate 1e-2);
- the schedules against optax's float32 values (JAX without x64, as the
  JAX step runs them): within ``SCHED_RTOL = 5e-7`` relative, a few float32
  ulps (XLA's and numpy's float32 cos differ in the last bit, and ``1 +
  cos`` cancels near the end of the decay); AdamW against optax in float64 with a constant rate:
  ``1e-12``, and in float32 under each schedule: ``2e-6`` (relative);
- float32 with the casts (the packages' real arithmetic): one step, the
  logits float32, the loss within 1e-5 relative, 99.9% of the parameter
  entries within ``TOL32 = 2e-5`` (the test's docstring says why not all);
- the port against itself (resume, rerun): bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_train_helpers as H
from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.train import adversarial as jax_adv
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial, optim

TOL64, TOL32, OPT_TOL, SCHED_RTOL = 1e-9, 2e-5, 1e-12, 5e-7
B = 4
BASE = dict(eps=0.03, alpha=0.01, attack_steps=2, learning_rate=1e-2, weight_decay=1e-2)
CASES = {
    "pgd-at": {},
    "clean_weight+smoothing": dict(clean_weight=0.4, label_smoothing=0.1),
    "grad_accum": dict(grad_accum=2),
    "remat": dict(remat=True),
    "ema": dict(ema_decay=0.7),
    "cosine+warmup": dict(lr_schedule="cosine", warmup_steps=1, total_steps=4),
}


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    x = rs.uniform(0.05, 0.95, (B, 32, 32, 3))
    return x, np.array([1, 4, 7, 2]), H.variables("wrn_tiny")


def _schedule_values(fn, counts):
    return [float(fn(c)) if callable(fn) else float(fn) for c in counts]


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="constant"), dict(lr_schedule="constant", warmup_steps=3),
    dict(lr_schedule="cosine", total_steps=7), dict(lr_schedule="cosine", warmup_steps=2,
                                                   total_steps=7)])
def test_schedules_equal_optaxs(kw):
    cfg = dict(learning_rate=0.3, **kw)
    counts = list(range(9))
    want = _schedule_values(jax_adv.make_lr_schedule(jax_adv.AdvTrainConfig(**cfg)),
                            [jnp.asarray(c, jnp.int32) for c in counts])
    got_fn = optim.make_lr_schedule(adversarial.AdvTrainConfig(**cfg))
    got = _schedule_values(got_fn, counts)
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)
    # a plain constant stays a float; a warmup's first update has lr 0
    assert callable(got_fn) == (kw != dict(lr_schedule="constant"))
    if kw.get("warmup_steps"):
        assert got[0] == 0.0 and got[1] > 0.0


def test_schedule_refusals_equal_jaxs():
    for cfg in (dict(lr_schedule="cosine"), dict(lr_schedule="step")):
        with pytest.raises(ValueError) as theirs:
            jax_adv.make_lr_schedule(jax_adv.AdvTrainConfig(**cfg))
        with pytest.raises(ValueError) as ours:
            optim.make_lr_schedule(adversarial.AdvTrainConfig(**cfg))
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("schedule", ["constant", "warmup", "cosine"])
def test_adamw_equals_optax(schedule):
    """Five updates of optax.adamw and the port's AdamW on the same
    parameters and gradients, and global_norm: float64 at a constant rate,
    float32 under the two schedules (optax's schedules are float32)."""
    cfg = {"constant": dict(lr_schedule="constant"),
           "warmup": dict(lr_schedule="constant", warmup_steps=2),
           "cosine": dict(lr_schedule="cosine", warmup_steps=1, total_steps=5)}[schedule]
    cfg = dict(learning_rate=0.05, weight_decay=0.03, **cfg)
    f64 = schedule == "constant"
    dt, tol = (np.float64, OPT_TOL) if f64 else (np.float32, 2e-6)
    rs = np.random.RandomState(2)
    params = {"a": rs.randn(3, 4).astype(dt), "b": rs.randn(5).astype(dt)}
    grads = [{k: rs.randn(*v.shape).astype(dt) for k, v in params.items()} for _ in range(5)]
    with jax.enable_x64(f64):
        tx = jax_adv._make_optimizer(jax_adv.AdvTrainConfig(**cfg))
        p_j, s_j = params, tx.init(params)
        norms_j = []
        for g in grads:
            u, s_j = tx.update(g, s_j, p_j)
            p_j = optax.apply_updates(p_j, u)
            norms_j.append(float(optax.global_norm(g)))
    tx_p = optim.AdamW(optim.make_lr_schedule(adversarial.AdvTrainConfig(**cfg)),
                       weight_decay=cfg["weight_decay"])
    p_p = {k: torch.from_numpy(v) for k, v in params.items()}
    s_p = tx_p.init(p_p)
    for g, norm in zip(grads, norms_j):
        g_t = {k: torch.from_numpy(v) for k, v in g.items()}
        p_p, s_p = tx_p.update(g_t, s_p, p_p)
        assert abs(float(optim.global_norm(g_t)) - norm) < tol * max(1.0, norm)
    assert s_p.count == int(s_j[0].count) == 5
    for k in params:
        for got, want in ((p_p[k], p_j[k]), (s_p.mu[k], s_j[0].mu[k]), (s_p.nu[k], s_j[0].nu[k])):
            want = np.asarray(want)
            assert got.dtype == torch.from_numpy(want).dtype
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=tol * max(1.0, float(np.abs(want).max())))


def _jax_run(make, cfg, var, x, y, keys, name="wrn_tiny"):
    """[JAX states after each step], [metrics]."""
    with jax.enable_x64():
        state = jax_adv.train_state_from_bundle(H.jax_bundle(name, var), cfg)
        step = jax.jit(make(cfg, *H.stats(name)))
        states, metrics = [state], []
        for k in keys:
            state, m = step(state, jnp.asarray(x), jnp.asarray(y), k)
            states.append(state)
            metrics.append({n: float(v) for n, v in m.items()})
    return states, metrics


def _port_run(make, cfg, var, x, y, jax_states, keys, feeder, objective, name="wrn_tiny"):
    template = adversarial.train_state_from_bundle(H.port_bundle(name, var), cfg)
    state = H.carry(template, jax_states[0], name)
    step = make(cfg, *H.stats(name))
    out = []
    for k in keys:
        feeder.add(H.step_draws(objective, cfg, k, x.shape), x.shape)
        state, m = step(state, H.t(x), H.t(y), generator_from_seed(0))
        out.append((state, {n: float(v) for n, v in m.items()}))
    assert feeder.empty()
    return out


def _compare(port_out, jax_states, jax_metrics, tol, name="wrn_tiny"):
    for (state, m), js, jm in zip(port_out, jax_states[1:], jax_metrics):
        assert state.step == int(js.step)
        assert H.max_diff(state.params, js.params, name) < tol
        assert H.max_diff(state.opt_state.mu, js.opt_state[0].mu, name) < tol
        assert H.max_diff(state.opt_state.nu, js.opt_state[0].nu, name) < tol
        if js.ema_params is not None:
            assert H.max_diff(state.ema_params, js.ema_params, name) < tol
        assert set(m) == set(jm)
        for k in jm:
            assert abs(m[k] - jm[k]) < tol, (k, m[k], jm[k])


@pytest.mark.parametrize("case", list(CASES))
def test_pgd_at_step_equals_jaxs(case, data, monkeypatch):
    x, y, var = data
    kw = {**BASE, **CASES[case]}
    keys = [jax.random.PRNGKey(40 + i) for i in range(3 if case == "cosine+warmup" else 2)]
    with H.lifted_casts():
        js, jm = _jax_run(jax_adv.make_train_step, jax_adv.AdvTrainConfig(**kw), var, x, y, keys)
        out = _port_run(adversarial.make_train_step, adversarial.AdvTrainConfig(**kw), var, x, y,
                        js, keys, H.Feeder(monkeypatch), "pgd-at")
    _compare(out, js, jm, TOL64)
    assert 0.0 < jm[-1]["grad_norm"] and jm[-1]["loss"] > 0.0


def test_carry_midway_continues_jaxs_run(data, monkeypatch):
    """The port started from the JAX state after one step (non-zero moments,
    count 1) makes JAX's second step."""
    x, y, var = data
    kw = {**BASE, "ema_decay": 0.5}
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    with H.lifted_casts():
        js, jm = _jax_run(jax_adv.make_train_step, jax_adv.AdvTrainConfig(**kw), var, x, y, keys)
        out = _port_run(adversarial.make_train_step, adversarial.AdvTrainConfig(**kw), var, x, y,
                        js[1:], keys[1:], H.Feeder(monkeypatch), "pgd-at")
    assert out[0][0].opt_state.count == 2
    _compare(out, js[1:], jm[1:], TOL64)


def test_float32_step_keeps_jaxs_casts(data, monkeypatch):
    """In float32 with the real casts (the logits float32 even for a float64
    input), one PGD-AT step: the loss and grad_norm within 1e-5 relative;
    all but at most 0.1% of the parameter entries within TOL32 of JAX's.
    The rest are entries whose gradient is within float32 noise of zero:
    Adam's first update is ``±lr`` for either sign, so they may differ by up
    to ``2 lr``."""
    x, y, var = data
    x, var32 = x.astype(np.float32), jax.tree_util.tree_map(lambda a: a.astype(np.float32), var)
    kw = dict(BASE, attack_steps=1)
    key = jax.random.PRNGKey(5)
    state = jax_adv.train_state_from_bundle(H.jax_bundle("wrn_tiny", var32, jnp.float32),
                                            jax_adv.AdvTrainConfig(**kw))
    new, jm = jax.jit(jax_adv.make_train_step(jax_adv.AdvTrainConfig(**kw), *H.stats("wrn_tiny")))(
        state, jnp.asarray(x), jnp.asarray(y), key)
    feeder = H.Feeder(monkeypatch)
    feeder.add(H.step_draws("pgd-at", jax_adv.AdvTrainConfig(**kw), key, x.shape, jnp.float32))
    cfg = adversarial.AdvTrainConfig(**kw)
    port = adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var32, torch.float32),
                                               cfg)
    logits = adversarial._make_apply_logits(cfg, *H.stats("wrn_tiny"))(
        port, port.params, H.t(x).double())
    assert logits.dtype == torch.float32
    ours, m = adversarial.make_train_step(cfg, *H.stats("wrn_tiny"))(
        port, H.t(x), H.t(y).long(), generator_from_seed(0))
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) < 1e-5 * float(jm[k])
    want = H.port_params(new.params)
    diff = np.concatenate([np.abs(ours.params[k].numpy() - want[k]).ravel() for k in want])
    assert np.mean(diff > TOL32) <= 1e-3 and diff.max() <= 2 * kw["learning_rate"] + TOL32


def test_eval_steps_equal_jaxs(data, monkeypatch):
    """make_eval_step (raw and EMA) and make_robust_eval_step on one state."""
    x, y, var = data
    kw = dict(BASE, ema_decay=0.5)
    key = jax.random.PRNGKey(3)
    with H.lifted_casts():
        js, _ = _jax_run(jax_adv.make_train_step, jax_adv.AdvTrainConfig(**kw), var, x, y, [key])
        mean, std = H.stats("wrn_tiny")
        with jax.enable_x64():
            want = [float(jax.jit(jax_adv.make_eval_step(mean, std, use_ema=e))(
                js[1], jnp.asarray(x), jnp.asarray(y))["clean_accuracy"]) for e in (False, True)]
            k_eval = jax.random.PRNGKey(9)
            want_r = float(jax.jit(jax_adv.make_robust_eval_step(3, 0.03, 0.01, mean, std,
                                                                  use_ema=True))(
                js[1], jnp.asarray(x), jnp.asarray(y), k_eval)["robust_accuracy"])
            start = H.t(jax.random.uniform(k_eval, x.shape, H.F64, -0.03, 0.03))
        cfg = adversarial.AdvTrainConfig(**kw)
        port = H.carry(adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var), cfg),
                       js[1])
        got = [float(adversarial.make_eval_step(mean, std, use_ema=e)(
            port, H.t(x), H.t(y))["clean_accuracy"]) for e in (False, True)]
        feeder = H.Feeder(monkeypatch)
        feeder.add({"start": [start]})
        got_r = float(adversarial.make_robust_eval_step(3, 0.03, 0.01, mean, std, use_ema=True)(
            port, H.t(x), H.t(y), generator_from_seed(0))["robust_accuracy"])
    assert got == want and got_r == want_r


def test_grad_accum_refuses_an_indivisible_batch(data):
    x, y, var = data
    cfg = adversarial.AdvTrainConfig(**dict(BASE, grad_accum=3))
    state = adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var), cfg)
    with pytest.raises(ValueError, match="batch size 4 is not divisible by grad_accum=3"):
        adversarial.make_train_step(cfg)(state, H.t(x), H.t(y), generator_from_seed(0))


def _three_steps(cfg, var, x, y, path=None):
    """Three PGD-AT steps, or one, a checkpoint, a fresh state loaded from it
    and two more when ``path`` is given."""
    fresh = lambda: adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var), cfg)  # noqa
    step = adversarial.make_train_step(cfg)
    state = fresh()
    for s in range(3):
        state, _ = step(state, H.t(x), H.t(y), generator_from_seed(100 + s))
        if path is not None and s == 0:
            adversarial.save_train_checkpoint(state, path, epoch=0)
            state, nxt = adversarial.load_train_checkpoint(fresh(), path)
            assert nxt == 1 and state.step == 1
    return state


def test_checkpoint_resume_is_exact(data, tmp_path):
    """One step, save, load into a fresh state, two more: bit-equal to three
    steps straight (parameters, moments, count, EMA); the file is written
    through a ``.tmp`` that does not remain."""
    x, y, var = data
    cfg = adversarial.AdvTrainConfig(**dict(BASE, ema_decay=0.5))
    path = tmp_path / "w.msgpack.ckpt"
    a = _three_steps(cfg, var, x, y)
    b = _three_steps(cfg, var, x, y, path)
    assert path.is_file() and not (tmp_path / "w.msgpack.ckpt.tmp").exists()
    for tree in ("params", "extra_variables", "ema_params"):
        for k, v in getattr(a, tree).items():
            assert torch.equal(v, getattr(b, tree)[k]), (tree, k)
    for k, v in a.opt_state.mu.items():
        assert torch.equal(v, b.opt_state.mu[k]) and torch.equal(a.opt_state.nu[k],
                                                                  b.opt_state.nu[k])
    assert a.opt_state.count == b.opt_state.count == 3 and a.step == b.step == 3
    assert adversarial.deploy_params(b) is b.ema_params


def test_checkpoint_without_ema_is_refused_by_an_ema_state(data, tmp_path):
    x, y, var = data
    plain = adversarial.train_state_from_bundle(
        H.port_bundle("wrn_tiny", var), adversarial.AdvTrainConfig(**BASE))
    adversarial.save_train_checkpoint(plain, tmp_path / "c.ckpt", epoch=4)
    ema = adversarial.train_state_from_bundle(
        H.port_bundle("wrn_tiny", var), adversarial.AdvTrainConfig(**dict(BASE, ema_decay=0.9)))
    with pytest.raises(ValueError, match="EMA"):
        adversarial.load_train_checkpoint(ema, tmp_path / "c.ckpt")
    restored, nxt = adversarial.load_train_checkpoint(plain, tmp_path / "c.ckpt")
    assert nxt == 5 and adversarial.deploy_params(restored) is restored.params
