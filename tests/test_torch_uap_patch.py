"""Universal perturbations and adversarial patches of the port
(attacks/uap.py, attacks/patch.py, attacks/eot.py::universal_perturbation,
defenses/tv.py::tv_transform) against the JAX package's on the CPU.

Float64 resnet_tiny, four 32x32 images (``_torch_blackbox_helpers``).  The
JAX attacks run jitted; their key chains are replayed outside the scans and
the draws fed to the port through ``uap.draw_start``,
``uap.draw_permutation``, ``patch.sample_placements`` and
``tv.draw_keep_mask``.  Tolerance: ``TOL = 1e-10`` on deltas, patches,
losses and images (float64); the paste and the rotations are exact;
``TV_TOL = 1e-6`` for the randomized TV transform, whose solve runs in
float32 in both packages (``test_torch_jpeg_tv.py`` holds ``tv_minimize`` to
the same bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_blackbox_helpers import feed, make_setup, run_jax, t
from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import eot as jax_eot
from image_recognition_adversarial_example_attack_tpu.attacks import patch as jax_patch
from image_recognition_adversarial_example_attack_tpu.attacks import uap as jax_uap
from image_recognition_adversarial_example_attack_tpu.defenses import tv as jax_tv
from image_recognition_adversarial_example_attack_tpu_torch.attacks import eot, patch, uap
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.defenses import tv

TOL = 1e-10
TV_TOL = 1e-6
EPS = 8 / 255


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _uap_draws(key, n: int, shape, eps: float, epochs: int, random_start: bool,
               full_batch: bool):
    """uap_attack's draws: ([the start] if random_start, [the permutation of
    each epoch] unless the run is one full batch)."""
    with jax.enable_x64():
        init_key, loop_key = jax.random.split(key)
        starts = ([t(jax.random.uniform(init_key, shape, jnp.float64, minval=-eps, maxval=eps))]
                  if random_start else [])
        perms = ([] if full_batch else
                 [t(jax.random.permutation(k, n)) for k in jax.random.split(loop_key, epochs)])
    return starts, perms


@pytest.mark.parametrize("batch_size,target,random_start", [
    (None, None, False), (None, 3, True), (2, None, True), (3, 5, False)])
def test_uap_attack_equals_jaxs(setup, monkeypatch, batch_size, target, random_start):
    lf_jax, lf_port, x, y = setup
    key, epochs = jax.random.PRNGKey(7), 4
    n = x.shape[0]
    full = batch_size is None
    starts, perms = _uap_draws(key, n, x.shape[1:], EPS, epochs, random_start, full)
    monkeypatch.setattr(uap, "draw_start", feed(starts))
    monkeypatch.setattr(uap, "draw_permutation", feed(perms))

    def jax_run(xx, yy):
        r = jax_uap.uap_attack(lf_jax, xx, yy, eps=EPS, epochs=epochs, batch_size=batch_size,
                               key=key, y_target=target, random_start=random_start)
        return r.delta, r.loss_per_epoch

    want_delta, want_loss = run_jax(jax_run, x, y)
    got = uap.uap_attack(lf_port, t(x), t(y), eps=EPS, epochs=epochs, batch_size=batch_size,
                         generator=generator_from_seed(0), y_target=target,
                         random_start=random_start)
    np.testing.assert_allclose(got.delta.numpy(), want_delta, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.loss_per_epoch.numpy(), want_loss, rtol=0, atol=TOL)
    assert float(got.delta.abs().max()) <= EPS + 1e-15
    # the fooling rate and the applied batch
    want_rate = run_jax(lambda xx, d: jax_uap.uap_fooling_rate(lf_jax, xx, d), x, want_delta)
    assert float(uap.uap_fooling_rate(lf_port, t(x), got.delta)) == float(want_rate)
    np.testing.assert_allclose(uap.apply_uap(t(x), got.delta).numpy(),
                               run_jax(jax_uap.apply_uap, x, want_delta), rtol=0, atol=TOL)


def test_uap_refuses_a_bad_batch_size(setup):
    _, lf_port, x, y = setup
    for bs in (0, 5):
        with pytest.raises(ValueError, match=r"batch_size \d must be in \[1, 4\]"):
            uap.uap_attack(lf_port, t(x), t(y), eps=EPS, batch_size=bs,
                           generator=generator_from_seed(0))


def test_universal_perturbation_equals_jaxs(setup, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key, steps = jax.random.PRNGKey(3), 3
    starts, _ = _uap_draws(key, x.shape[0], x.shape[1:], EPS, steps, True, True)
    monkeypatch.setattr(uap, "draw_start", feed(starts))
    want = run_jax(lambda xx, yy: jax_eot.universal_perturbation(
        lf_jax, xx, yy, eps=EPS, alpha=EPS / 4, steps=steps, key=key), x, y)
    got = eot.universal_perturbation(lf_port, t(x), t(y), eps=EPS, alpha=EPS / 4, steps=steps,
                                     generator=generator_from_seed(0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rotation_is_jnp_rot90(k):
    p = np.random.RandomState(k).rand(5, 5, 3)
    np.testing.assert_array_equal(torch.rot90(t(p), k, dims=(0, 1)).numpy(),
                                  run_jax(lambda q: jnp.rot90(q, k), p))


# explicit placements: every rotation, and starts past either edge, which
# lax.dynamic_update_slice (and so the port) takes as it does: a negative
# start plus the axis length, then clamped so that the patch fits
PLACEMENTS = [
    ([0, 3, 10, 1], [2, 0, 5, 7], [0, 1, 2, 3]),
    ([-4, 30, 25, 100], [9, -1, 40, 2], [3, 2, 1, 0]),
    ([-100, -16, 11, 12], [-13, -12, 7, 8], [1, 1, 2, 2]),
]


@pytest.mark.parametrize("rows,cols,rots", PLACEMENTS)
def test_apply_patch_and_its_gradient_equal_jaxs(rows, cols, rots):
    rs = np.random.RandomState(1)
    x = rs.rand(4, 16, 12, 3)
    p = rs.rand(5, 5, 3)
    w = rs.randn(4, 16, 12, 3)
    r, c, k = (np.asarray(v) for v in (rows, cols, rots))

    def jax_fn(xx, pp):
        out = jax_patch.apply_patch(xx, pp, rows=r, cols=c, rots=k)
        return out, jax.grad(lambda q: jnp.sum(
            jax_patch.apply_patch(xx, q, rows=r, cols=c, rots=k) * w))(pp)

    want, want_grad = run_jax(jax_fn, x, p)
    q = t(p).requires_grad_(True)
    got = patch.apply_patch(t(x), q, rows=t(r), cols=t(c), rots=t(k))
    (got * t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(q.grad.numpy(), want_grad, rtol=0, atol=1e-12)


def test_apply_patch_refuses_what_jaxs_refuses():
    x, p = np.zeros((2, 8, 8, 3)), np.zeros((3, 3, 3))
    rows = cols = np.zeros(2, np.int64)
    cases = [
        ({"rows": rows}, "rows/cols must be passed together"),
        ({}, "apply_patch needs either explicit placements or a key"),
        ({"rows": rows, "cols": cols}, "rots is required with explicit placements"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jax_patch.apply_patch(jnp.asarray(x), jnp.asarray(p), **kw)
        with pytest.raises(ValueError, match=msg):
            patch.apply_patch(t(x), t(p), **{k: t(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match="not both"):
        jax_patch.apply_patch(jnp.asarray(x), jnp.asarray(p), rows=rows, cols=cols,
                              key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="not both"):
        patch.apply_patch(t(x), t(p), rows=t(rows), cols=t(cols),
                          generator=generator_from_seed(0))
    # rotations=False needs no rots
    out = patch.apply_patch(t(x), t(p) + 1, rows=t(rows), cols=t(cols), rotations=False)
    assert float(out[:, :3, :3].min()) == 1.0 and float(out.sum()) == 2 * 27


def _placement_draws(keys, n, hw, p, rotations):
    with jax.enable_x64():
        return [tuple(t(v) for v in jax_patch.sample_placements(k, n, hw, p,
                                                                rotations=rotations))
                for k in keys]


@pytest.mark.parametrize("target,rotations", [(None, True), (2, True), (4, False)])
def test_patch_attack_equals_jaxs(setup, monkeypatch, target, rotations):
    lf_jax, lf_port, x, y = setup
    key, steps, size = jax.random.PRNGKey(11), 5, 9
    draws = _placement_draws(jax.random.split(key, steps), 4, (32, 32), size, rotations)
    monkeypatch.setattr(patch, "sample_placements", feed(draws))

    def jax_run(xx, yy):
        r = jax_patch.patch_attack(lf_jax, xx, yy, patch_size=size, steps=steps, lr=0.05,
                                   key=key, y_target=target, rotations=rotations)
        return r.patch, r.loss_per_step

    want_patch, want_loss = run_jax(jax_run, x, y)
    got = patch.patch_attack(lf_port, t(x), t(y), patch_size=size, steps=steps, lr=0.05,
                             generator=generator_from_seed(0), y_target=target,
                             rotations=rotations)
    np.testing.assert_allclose(got.patch.numpy(), want_patch, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.loss_per_step.numpy(), want_loss, rtol=0, atol=TOL)
    assert 0.0 <= float(got.patch.min()) and float(got.patch.max()) <= 1.0

    # the success rate at one more draw of placements
    eval_key = jax.random.fold_in(key, 1)
    monkeypatch.setattr(patch, "sample_placements",
                        feed(_placement_draws([eval_key], 4, (32, 32), size, rotations)))
    kw = {"y_target": target} if target is not None else {}
    want_rate = run_jax(lambda xx, pp, yy: jax_patch.patch_success_rate(
        lf_jax, xx, pp, key=eval_key, rotations=rotations,
        **(kw or {"ys": yy})), x, want_patch, y)
    got_rate = patch.patch_success_rate(lf_port, t(x), got.patch, generator=generator_from_seed(0),
                                        rotations=rotations, **(kw or {"ys": t(y)}))
    assert float(got_rate) == float(want_rate)


def test_patch_attack_refuses_a_bad_size(setup):
    _, lf_port, x, y = setup
    for size in (0, 33):
        with pytest.raises(ValueError, match=r"patch_size \d+ must be in \[1, 32\]"):
            patch.patch_attack(lf_port, t(x), t(y), patch_size=size, steps=1,
                               generator=generator_from_seed(0))
    with pytest.raises(ValueError, match="untargeted success needs ys"):
        patch.patch_success_rate(lf_port, t(x), torch.zeros(3, 3, 3, dtype=torch.float64),
                                 generator=generator_from_seed(0))


def test_sample_placements_fit_and_cover():
    rows, cols, rots = patch.sample_placements(generator_from_seed(0), 4000, (20, 12), 5)
    assert int(rows.min()) == 0 and int(rows.max()) == 15
    assert int(cols.min()) == 0 and int(cols.max()) == 7
    assert set(rots.tolist()) == {0, 1, 2, 3}
    _, _, rots = patch.sample_placements(generator_from_seed(0), 50, (20, 12), 5,
                                         rotations=False)
    assert not rots.any()


@pytest.mark.parametrize("keep_prob", [0.5, 0.8])
def test_tv_transform_equals_jaxs(monkeypatch, keep_prob):
    """One draw of the randomized TV defense: JAX's Bernoulli mask fed
    through ``draw_keep_mask``; the float32 solve within ``TV_TOL``."""
    x = np.random.RandomState(3).rand(2, 12, 10, 3)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64():
        mask = jax.random.bernoulli(key, p=keep_prob, shape=(2, 12, 10, 1))
    monkeypatch.setattr(tv, "draw_keep_mask", feed([t(np.asarray(mask, np.float64))]))
    want = run_jax(lambda xx: jax_tv.tv_transform(steps=10, keep_prob=keep_prob)(key, xx), x)
    got = tv.tv_transform(steps=10, keep_prob=keep_prob)(generator_from_seed(0), t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TV_TOL)


def test_tv_transform_draws_a_channel_shared_mask():
    m = tv.draw_keep_mask((2, 64, 64, 1), 0.3, generator_from_seed(1), "cpu")
    assert m.shape == (2, 64, 64, 1) and set(m.unique().tolist()) == {0.0, 1.0}
    assert abs(float(m.mean()) - 0.3) < 0.02
    # the EOT wrapper takes it as a transform: one [n*B] forward
    x = torch.rand(2, 8, 8, 3, generator=generator_from_seed(2))
    calls = []

    def lf(z):
        calls.append(z.shape[0])
        return z.mean(dim=(1, 2))

    out = eot.make_eot_logits_fn(lf, generator_from_seed(0), n_samples=3,
                                 transform=tv.tv_transform(steps=3))(x)
    assert out.shape == (2, 3) and calls == [6]
