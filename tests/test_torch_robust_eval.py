"""The port's EOT wrapper (attacks/eot.py), AutoAttack protocols
(eval/robust_eval.py) and ``stream_robust_cell`` against the JAX package's
on the CPU.

- the EOT mix (the wrapping int32 sum of the float32 bits) bit-equal to
  JAX's, and the wrapped logits and their input gradient with JAX's normals
  fed through ``call_generator`` / ``draw_noise``;
- ``autoattack_lite``, ``autoattack`` in both norms and ``autoattack_rand``
  at cut budgets on float64 resnet_tiny, every draw JAX's for the key (the
  arms' keys split as the JAX protocols split them): the success masks
  equal, the worst-case batch within 1e-9;
- ``robust_accuracy`` and its NaN;
- ``stream_robust_cell`` equal to one resident run a chunk, each under that
  chunk's generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_blackbox_helpers import (TOL, apgd_draw, constant, eot_normals, feed, make_setup,
                                     run_jax, square_draws, square_l2_draws, t)
from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import eot as jax_eot
from image_recognition_adversarial_example_attack_tpu.eval import robust_eval as jax_re
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    apgd, eot, fab, make_logits_fn, predict_labels, square)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
    chunk_generator, generator_from_seed)
from image_recognition_adversarial_example_attack_tpu_torch.eval import robust_eval
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
    make_placer, stream_robust_cell)
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

EPS = {"linf": 8 / 255, "l2": 0.5}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eot_mix_is_jaxs_bit_for_bit(dtype):
    """A 2x64x64x3 batch: the int32 sum wraps many times over.  JAX's own
    int32 sum (x64 off: with it on, ``jnp.sum`` widens to int64, whose low
    32 bits ``fold_in`` takes, the same key)."""
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (2, 64, 64, 3)).astype(dtype)
    x[0, 0, 0] = [0.0, 1.0, -0.0]
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x.astype(np.float32)), jnp.int32)
    want = jnp.sum(bits)
    assert want.dtype == jnp.int32
    want = int(want)
    got = eot.input_mix(t(x))
    assert got.dtype == torch.int32 and got.ndim == 0
    assert int(got) == want
    # wrapping, not saturating: a one-ulp change anywhere moves it
    x2 = x.copy()
    x2[1, 63, 63, 2] = np.nextafter(np.float32(x2[1, 63, 63, 2]), np.float32(2))
    assert int(eot.input_mix(t(x2))) != want


def _feed_eot(monkeypatch, keys: dict, n: int, shape):
    """Each wrapper's seed is the name of its JAX key (in creation order);
    each call's normals are JAX's for ``fold_in(key, mix)``."""
    monkeypatch.setattr(eot, "seed_draw", feed(list(keys)))
    monkeypatch.setattr(eot, "call_generator",
                        lambda seed, mix, device: iter(eot_normals(keys[seed], mix, n, shape)))
    monkeypatch.setattr(eot, "draw_noise", lambda shape_, g, device: next(g))


def test_make_eot_logits_fn_equals_jaxs(setup, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key, n = jax.random.PRNGKey(12), 3
    _feed_eot(monkeypatch, {"wrap": key}, n, x.shape)
    fn = eot.make_eot_logits_fn(lf_port, generator_from_seed(0), n_samples=n, sigma=0.25)

    def jax_value_and_grad(xx):
        f = jax_eot.make_eot_logits_fn(lf_jax, key, n_samples=n, sigma=0.25)
        out = f(xx)
        g = jax.grad(lambda z: jnp.sum(jnp.take_along_axis(f(z), jnp.asarray(y)[:, None], -1)))
        return out, g(xx)

    want_out, want_g = run_jax(jax_value_and_grad, x)
    xt = t(x).requires_grad_(True)
    out = fn(xt)
    (g,) = torch.autograd.grad(out.gather(-1, t(y)[:, None]).sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-12)
    # log of a distribution
    np.testing.assert_allclose(np.exp(out.detach().numpy()).sum(-1), 1.0, atol=1e-12)


def test_eot_draws_follow_the_seed_and_the_input():
    lf = lambda z: z.reshape(z.shape[0], -1)[:, :5]  # noqa: E731
    x = torch.rand(2, 4, 4, 3, generator=torch.Generator().manual_seed(1))
    a = eot.make_eot_logits_fn(lf, generator_from_seed(0), n_samples=2)
    b = eot.make_eot_logits_fn(lf, generator_from_seed(0), n_samples=2)
    c = eot.make_eot_logits_fn(lf, generator_from_seed(1), n_samples=2)
    assert torch.equal(a(x), a(x)) and torch.equal(a(x), b(x))
    assert not torch.equal(a(x), c(x))
    assert not torch.equal(a(x), a(x + 1e-3))


def _feed_apgd_fab(monkeypatch, keys, shape, eps, norm):
    draws = feed([apgd_draw(k, shape, eps, norm) for k in keys])
    monkeypatch.setattr(apgd, "draw_start", draws)
    monkeypatch.setattr(fab, "draw_start", draws)


def _feed_square(monkeypatch, key, steps, shape, norm):
    if norm == "linf":
        monkeypatch.setattr(square, "draw_square", constant(square_draws(key, steps, shape)))
    else:
        monkeypatch.setattr(square, "draw_square_l2",
                            constant(square_l2_draws(key, steps, shape)))


def _check(got, want, fields, tol):
    np.testing.assert_allclose(got.x_adv.numpy(), np.asarray(want[0]), rtol=0, atol=tol)
    for i, name in enumerate(fields, start=1):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want[i]),
                                      err_msg=name)


def test_autoattack_lite_equals_jaxs(setup, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key, eps = jax.random.PRNGKey(13), EPS["linf"]
    kw = dict(apgd_steps=4, square_steps=10, deepfool_steps=3)
    with jax.enable_x64():
        k_apgd, k_square = jax.random.split(key)
    _feed_apgd_fab(monkeypatch, [k_apgd], x.shape, eps, "linf")
    _feed_square(monkeypatch, k_square, kw["square_steps"], x.shape, "linf")
    want = run_jax(lambda xx: tuple(jax_re.autoattack_lite(lf_jax, xx, jnp.asarray(y), eps=eps,
                                                           key=key, **kw)), x)
    got = robust_eval.autoattack_lite(lf_port, t(x), t(y), eps=eps,
                                      generator=generator_from_seed(0), **kw)
    _check(got, want, ("success", "success_apgd", "success_square", "success_deepfool"), TOL)
    assert got.success.any()


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_autoattack_equals_jaxs(setup, norm, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key, eps, nt = jax.random.PRNGKey(14), EPS[norm], 2
    kw = dict(apgd_steps=3, apgd_t_steps=3, apgd_t_targets=nt, fab_steps=2, fab_targets=nt,
              square_steps=10, norm=norm)
    with jax.enable_x64():
        k_ce, k_t, k_fab, k_sq = jax.random.split(key, 4)
        keys = [k_ce, *jax.random.split(k_t, nt), *jax.random.split(k_fab, nt)]
    _feed_apgd_fab(monkeypatch, keys, x.shape, eps, norm)
    _feed_square(monkeypatch, k_sq, kw["square_steps"], x.shape, norm)
    want = run_jax(lambda xx: tuple(jax_re.autoattack(lf_jax, xx, jnp.asarray(y), eps=eps,
                                                      key=key, **kw)), x)
    got = robust_eval.autoattack(lf_port, t(x), t(y), eps=eps,
                                 generator=generator_from_seed(0), **kw)
    _check(got, want, ("success", "success_apgd_ce", "success_apgd_t", "success_fab",
                       "success_square"), TOL)
    assert got.success.any()


def test_autoattack_rand_equals_jaxs(setup, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key, eps, n = jax.random.PRNGKey(15), EPS["linf"], 2
    kw = dict(eot_samples=n, sigma=0.25, apgd_steps=3, square_steps=6)
    with jax.enable_x64():
        k_wrap, k_ce, k_dlr, k_sq, k_eval = jax.random.split(key, 5)
    _feed_eot(monkeypatch, {"wrap": k_wrap, "eval": k_eval}, n, x.shape)
    _feed_apgd_fab(monkeypatch, [k_ce, k_dlr], x.shape, eps, "linf")
    _feed_square(monkeypatch, k_sq, kw["square_steps"], x.shape, "linf")
    want = run_jax(lambda xx: tuple(jax_re.autoattack_rand(lf_jax, xx, jnp.asarray(y), eps=eps,
                                                           key=key, **kw)), x)
    got = robust_eval.autoattack_rand(lf_port, t(x), t(y), eps=eps,
                                      generator=generator_from_seed(0), **kw)
    _check(got, want, ("success", "success_apgd_ce", "success_apgd_dlr", "success_square"),
           TOL)


def test_robust_accuracy_equals_jaxs_and_is_nan_without_clean_correct():
    succ = np.array([True, False, False, True, False])
    cc = np.array([True, True, False, True, True])
    res = robust_eval.RobustEvalResult(None, torch.from_numpy(succ), None, None, None)
    jres = jax_re.RobustEvalResult(None, jnp.asarray(succ), None, None, None)
    assert robust_eval.robust_accuracy(res, cc) == pytest.approx(
        jax_re.robust_accuracy(jres, cc), abs=1e-7) == pytest.approx(0.5)
    assert np.isnan(robust_eval.robust_accuracy(res, np.zeros(5, bool)))
    assert np.isnan(jax_re.robust_accuracy(jres, np.zeros(5, bool)))


@pytest.mark.parametrize("with_labels", [False, True])
def test_stream_robust_cell_equals_per_chunk_resident_runs(tmp_path, with_labels):
    """Four PNGs in chunks of two: the streamed vectors are the two resident
    runs', each under its chunk's generator (``-1`` labels take the
    pseudo-label)."""
    rs = np.random.RandomState(3)
    paths = []
    for i in range(4):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray((rs.rand(32, 32, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    b = zoo.load_model("resnet_tiny", device="cpu")
    lf = make_logits_fn(b.model, b.mean, b.std)

    def run(x, y, g, eps):
        res = robust_eval.autoattack_lite(lf, x, y, eps=eps, generator=g, apgd_steps=2,
                                          square_steps=4, deepfool_steps=2)
        return res.success, res.success_apgd, res.success_square, res.success_deepfool

    labels = np.array([3, -1, -1, 5]) if with_labels else None
    cache: dict = {}
    got = stream_robust_cell(run, paths, seed=7, cell_id="lite:0.031373", eps=8 / 255,
                             chunk_size=2, place=make_placer("cpu"), size=32,
                             pseudo_label_fn=lambda xx: predict_labels(lf, xx),
                             labels=labels, clean_cache=cache)
    assert sorted(got) == ["arm0", "arm1", "arm2", "arm3", "clean_correct"]
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import (
        load_image_batch)

    for step in range(2):
        x = torch.from_numpy(load_image_batch(paths[2 * step:2 * step + 2], size=32))
        pseudo = predict_labels(lf, x)
        y = pseudo.clone()
        if labels is not None:
            chunk = torch.from_numpy(labels[2 * step:2 * step + 2])
            y = torch.where(chunk < 0, pseudo, chunk)
        outs = run(x, y, chunk_generator(7, "lite:0.031373", step), 8 / 255)
        for i, v in enumerate(outs):
            np.testing.assert_array_equal(got[f"arm{i}"][2 * step:2 * step + 2], v.numpy())
        np.testing.assert_array_equal(got["clean_correct"][2 * step:2 * step + 2],
                                      (pseudo == y).numpy())
    assert set(cache) == {0, 1, "__sig__"}
    if with_labels:
        assert got["clean_correct"][[1, 2]].all()
