"""Randomized smoothing of the port (defenses/smoothing.py) against the JAX
package's on the CPU.

Float64 resnet_tiny and three 32x32 images (``_torch_blackbox_helpers``).
JAX's key chain (``split`` per chunk, ``fold_in`` per slice of
``max_batch`` images, ``split`` into selection and estimation) is replayed
and its Gaussian noise fed through ``smoothing.draw_noise``.  Tolerances:
the vote counts are EXACTLY equal for the same noise, and the certified
classes and radii (scipy on the host in both packages) are equal for the
same counts.

Under x64, ``jnp.sum`` of the int32 one-hot votes returns int64 and the JAX
scan's int32 carry refuses it; the tests run the JAX module with a
``jnp`` whose ``sum`` keeps the votes' int32 (``_Int32Sums``), which
changes no count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_blackbox_helpers import feed, make_setup, t
from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.defenses import smoothing as jax_sm
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.defenses import smoothing


class _Int32Sums:
    """``jax.numpy`` with a ``sum`` that keeps its input's integer dtype."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def sum(a, axis=None, **kw):
        if jnp.issubdtype(a.dtype, jnp.integer):
            kw.setdefault("dtype", a.dtype)
        return jnp.sum(a, axis=axis, **kw)


@pytest.fixture(scope="module")
def setup():
    lf_jax, lf_port, x, y = make_setup(n=3)
    return lf_jax, lf_port, x, y


@pytest.fixture(autouse=True)
def int32_votes(monkeypatch):
    monkeypatch.setattr(jax_sm, "jnp", _Int32Sums())


def _chunk_noise(key, n_chunks: int, shape) -> list:
    with jax.enable_x64():
        return [t(jax.random.normal(k, shape, jnp.float64))
                for k in jax.random.split(key, n_chunks)]


def _sample_noise(key, b: int, mb: int, n: int, chunk: int, shape) -> list:
    """The noise of ``SmoothedClassifier._sample(x, key, n)``, in draw order."""
    n_chunks = smoothing._n_chunks(n, chunk)
    out = []
    for i in range(0, b, mb):
        with jax.enable_x64():
            kk = jax.random.fold_in(key, i)
        out += _chunk_noise(kk, n_chunks, (chunk, mb) + tuple(shape))
    return out


def test_config_equals_jaxs():
    assert dataclasses.asdict(smoothing.SmoothingConfig()) == dataclasses.asdict(
        jax_sm.SmoothingConfig())
    assert smoothing.ABSTAIN == jax_sm.ABSTAIN == -1


@pytest.mark.parametrize("sigma,n_chunks", [(0.12, 1), (0.5, 3)])
def test_votes_equal_jaxs_for_the_same_noise(setup, monkeypatch, sigma, n_chunks):
    lf_jax, lf_port, x, _ = setup
    chunk, key = 4, jax.random.PRNGKey(2)
    monkeypatch.setattr(smoothing, "draw_noise",
                        feed(_chunk_noise(key, n_chunks, (chunk,) + x.shape)))
    with jax.enable_x64():
        want = np.asarray(jax_sm.make_counts_fn(lf_jax, chunk)(
            jnp.asarray(x), key, jnp.float64(sigma), n_chunks))
    fn = smoothing.make_counts_fn(lf_port, chunk)
    got = fn(t(x), generator_from_seed(0), sigma, n_chunks)
    assert fn.chunk == chunk and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(dim=1) == n_chunks * chunk).all()


def test_certify_and_predict_equal_jaxs(setup, monkeypatch):
    """The whole CERTIFY and PREDICT on the same noise, three images in
    slices of two (the second zero-padded)."""
    lf_jax, lf_port, x, _ = setup
    cfg = dict(sigma=0.25, n0=8, n=24, chunk=4, alpha=0.01, max_batch=2)
    key = jax.random.PRNGKey(4)
    with jax.enable_x64():
        k0, k1 = jax.random.split(key)
    noise = (_sample_noise(k0, 3, 2, cfg["n0"], 4, x.shape[1:])
             + _sample_noise(k1, 3, 2, cfg["n"], 4, x.shape[1:]))
    monkeypatch.setattr(smoothing, "draw_noise", feed(noise))
    with jax.enable_x64():
        jax_clf = jax_sm.SmoothedClassifier(lf_jax, jax_sm.SmoothingConfig(**cfg))
        want_cls, want_r = jax_clf.certify(jnp.asarray(x), key)
        want_pred = jax_clf.predict(jnp.asarray(x), key)
    clf = smoothing.SmoothedClassifier(lf_port, smoothing.SmoothingConfig(**cfg))
    got_cls, got_r = clf.certify(t(x), generator_from_seed(0))
    np.testing.assert_array_equal(got_cls, want_cls)
    np.testing.assert_array_equal(got_r, want_r)
    monkeypatch.setattr(smoothing, "draw_noise",
                        feed(_sample_noise(key, 3, 2, cfg["n"], 4, x.shape[1:])))
    np.testing.assert_array_equal(clf.predict(t(x), generator_from_seed(0)), want_pred)


def test_statistics_equal_jaxs_on_given_counts(monkeypatch):
    """Clopper-Pearson, the binomial test and the radius on hand-made votes:
    a sure class, a split that abstains, a weak majority, a zero count."""
    counts0 = np.array([[30, 2, 0], [10, 12, 10], [20, 12, 0], [0, 0, 32]], np.int32)
    counts = np.array([[500, 12, 0], [250, 262, 0], [300, 212, 0], [0, 0, 512]], np.int32)
    cfg = jax_sm.SmoothingConfig(sigma=0.5)
    jax_clf = jax_sm.SmoothedClassifier(lambda v: v, cfg, counts_fn=lambda *a: None)
    calls = iter([counts0, counts])
    monkeypatch.setattr(jax_clf, "_sample", lambda *a: next(calls))
    want_cls, want_r = jax_clf.certify(jnp.zeros((4, 2, 2, 3)), jax.random.PRNGKey(0))
    clf = smoothing.SmoothedClassifier(lambda v: v, smoothing.SmoothingConfig(sigma=0.5),
                                       counts_fn=lambda *a: None)
    got_cls, got_r = clf.certify_counts(counts0, counts)
    np.testing.assert_array_equal(got_cls, want_cls)
    np.testing.assert_array_equal(got_r, want_r)
    assert got_cls[1] == smoothing.ABSTAIN and got_r[1] == 0.0 and got_r[0] > 0
    monkeypatch.setattr(jax_clf, "_sample", lambda *a: counts)
    monkeypatch.setattr(clf, "_sample", lambda *a: counts)
    np.testing.assert_array_equal(clf.predict(None, None),
                                  jax_clf.predict(None, jax.random.PRNGKey(0)))


def test_a_counts_fn_of_another_chunk_is_refused():
    fn = smoothing.make_counts_fn(lambda v: v, 16)
    with pytest.raises(ValueError, match="chunk=16 but the config says chunk=32"):
        smoothing.SmoothedClassifier(lambda v: v, smoothing.SmoothingConfig(), counts_fn=fn)
    with pytest.raises(ValueError, match="chunk=16 but the config says chunk=32"):
        jax_sm.SmoothedClassifier(lambda v: v, jax_sm.SmoothingConfig(),
                                  counts_fn=jax_sm.make_counts_fn(lambda v: v, 16))


def test_noise_is_unclipped_and_one_forward_a_chunk(setup):
    _, lf_port, x, _ = setup
    seen = []

    def lf(z):
        seen.append((z.shape[0], float(z.min()), float(z.max())))
        return lf_port(z)

    clf = smoothing.SmoothedClassifier(lf, smoothing.SmoothingConfig(n0=4, n=8, chunk=4,
                                                                      max_batch=4))
    counts = clf._sample(t(x), generator_from_seed(1), 8)
    assert counts.shape == (3, 10) and (counts.sum(axis=1) == 8).all()
    assert [s[0] for s in seen] == [12, 12]  # chunk x min(B, max_batch)
    assert min(s[1] for s in seen) < 0.0 and max(s[2] for s in seen) > 1.0
