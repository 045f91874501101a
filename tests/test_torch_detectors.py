"""The port's squeezing and Mahalanobis detectors against the JAX package (CPU).

The squeezing score runs three forwards of bridged resnet_tiny weights and
the two squeezers, which are bit-exact in float32: it is held to 1e-12
relative in float64 (on logits that stay float64, since ``make_logits_fn``
casts to float32 on both sides) and to 1e-6 absolute through the float32
``make_logits_fn``.

The JAX package fits the Mahalanobis Gaussians in float32 whatever its
input.  For a float64 oracle its own code runs with ``jnp.float32`` read as
``jnp.float64`` (the module's ``jnp`` is replaced in the test, nothing of
the package changes); the port keeps float64 input in float64.  Fit, score
and calibration are then held to 1e-9 relative, with N < C, an empty class
and N > C; in float32 both sides fit in float32 and agree to 2e-3 of the
largest entry (the N < C covariance is ill-conditioned).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.defenses import mahalanobis as jax_mahal
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
    MahalanobisParams, calibrate_mahalanobis, calibrate_squeezing_threshold,
    fit_mahalanobis, is_adversarial_by_feature, is_adversarial_by_mahalanobis,
    is_adversarial_by_squeezing, mahalanobis_score_from_features, make_features_fn,
    pool_features, squeezing_score)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


class _Float64Jnp:
    """``jnp`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture()
def jax_mahal64(monkeypatch):
    monkeypatch.setattr(jax_mahal, "jnp", _Float64Jnp())
    return jax_mahal


def _models(dtype):
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", dtype, num_classes=10, seed=11)
        model = port_resnet("resnet_tiny", variables, dtype, num_classes=10)
    if dtype == np.float64:
        return uncast_fns(module, variables, model)
    return {
        "jax": (jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD),
                jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)),
        "port": (make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                 make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)),
    }


@pytest.fixture(scope="module")
def nets():
    return {np.float64: _models(np.float64), np.float32: _models(np.float32)}


def _batch(dtype, n=6, seed=3):
    # values outside [0,1] exercise the quantizer's clip
    return np.random.RandomState(seed).uniform(-0.05, 1.05, (n, 32, 32, 3)).astype(dtype)


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-12, 0.0), (np.float32, 0.0, 1e-6)])
def test_squeezing_score_matches(nets, dtype, rtol, atol):
    lf_jax, lf = nets[dtype]["jax"][0], nets[dtype]["port"][0]
    x = _batch(dtype)
    want = np.asarray(jax_det.squeezing_score(lf_jax, jnp.asarray(x), 16))
    with torch.no_grad():
        got = squeezing_score(lf, torch.from_numpy(x), 16).numpy()
    assert got.dtype == want.dtype and got.shape == (6,)
    assert float(want.min()) > 0  # the squeezers move every prediction
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_squeezing_score_has_a_straight_through_gradient(nets):
    """The quantization's gradient is the identity, so a detector-aware
    attack gets a nonzero gradient through the squeezer."""
    lf = nets[np.float64]["port"][0]
    x = torch.from_numpy(_batch(np.float64, n=2)).requires_grad_(True)
    (g,) = torch.autograd.grad(squeezing_score(lf, x).sum(), x)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("n,quantile", [(6, 0.95), (4, 0.5), (100, 0.8)])
def test_calibrate_squeezing_threshold_matches(nets, n, quantile):
    lf_jax, lf = nets[np.float64]["jax"][0], nets[np.float64]["port"][0]
    x = _batch(np.float64, seed=4)
    want = jax_det.calibrate_squeezing_threshold(lf_jax, jnp.asarray(x), n=n, quantile=quantile)
    got = calibrate_squeezing_threshold(lf, torch.from_numpy(x), n=n, quantile=quantile)
    assert got == pytest.approx(want, rel=1e-9, abs=0)
    with pytest.raises(ValueError, match="no calibration images"):
        calibrate_squeezing_threshold(lf, torch.from_numpy(x), n=0)


def _feats(n, c, k, seed, empty=()):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k, size=n)
    for e in empty:
        labels[labels == e] = (e + 1) % k
    centers = rng.randn(k, c) * 2.0
    return centers[labels] + rng.randn(n, c), labels


# N < C (the 100-image calibration against 1024 channels), a class with no
# sample, and N > C
FIT_CASES = {"n_lt_c": (6, 16, 4, ()), "empty_class": (30, 8, 5, (2,)),
             "n_gt_c": (60, 8, 3, ())}


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_and_score_match_float64(jax_mahal64, case):
    n, c, k, empty = FIT_CASES[case]
    f, labels = _feats(n, c, k, seed=5, empty=empty)
    want = jax_mahal64.fit_mahalanobis(jnp.asarray(f), jnp.asarray(labels), k)
    got = fit_mahalanobis(torch.from_numpy(f), torch.from_numpy(labels), k)
    assert got.mean.dtype == torch.float64 and np.asarray(want.mean).dtype == np.float64
    _close(got.mean.numpy(), np.asarray(want.mean), 1e-9)
    _close(got.precision.numpy(), np.asarray(want.precision), 1e-9)
    if empty:  # an empty class takes the global mean
        np.testing.assert_allclose(got.mean[empty[0]].numpy(), f.mean(axis=0), rtol=1e-12)
    # scores of fresh NHWC maps (pooled) and of vectors, against each side's fit
    z4 = np.random.RandomState(6).randn(5, 2, 3, c) + f[:5, None, None, :]
    for z in (z4, f[:9]):
        s_want = np.asarray(jax_mahal64.mahalanobis_score_from_features(jnp.asarray(z), want))
        s_got = mahalanobis_score_from_features(torch.from_numpy(z), got).numpy()
        _close(s_got, s_want, 1e-9)
        assert (s_got >= 0).all()


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_and_score_match_float32(case):
    n, c, k, empty = FIT_CASES[case]
    f, labels = _feats(n, c, k, seed=7, empty=empty)
    f = f.astype(np.float32)
    want = jax_mahal.fit_mahalanobis(jnp.asarray(f), jnp.asarray(labels), k)
    got = fit_mahalanobis(torch.from_numpy(f), torch.from_numpy(labels), k)
    assert got.precision.dtype == torch.float32
    _close(got.mean.numpy(), np.asarray(want.mean), 1e-6)
    _close(got.precision.numpy(), np.asarray(want.precision), 2e-3)
    s_want = np.asarray(jax_mahal.mahalanobis_score_from_features(jnp.asarray(f), want))
    s_got = mahalanobis_score_from_features(torch.from_numpy(f), got).numpy()
    _close(s_got, s_want, 2e-3)
    # bf16 features are fitted in float32
    half = fit_mahalanobis(torch.from_numpy(f).bfloat16(), torch.from_numpy(labels), k)
    assert half.precision.dtype == torch.float32


def test_pool_features_matches():
    f = np.random.RandomState(8).randn(3, 4, 5, 6)
    for z in (f, f.reshape(3, -1), f[:, 0, 0]):
        np.testing.assert_allclose(pool_features(torch.from_numpy(z)).numpy(),
                                   np.asarray(jax_mahal.pool_features(jnp.asarray(z))),
                                   rtol=1e-13)


@pytest.mark.parametrize("n,quantile", [(6, 0.95), (3, 0.5)])
def test_calibrate_mahalanobis_matches(nets, jax_mahal64, n, quantile):
    ff_jax, ff = nets[np.float64]["jax"][1], nets[np.float64]["port"][1]
    x = _batch(np.float64, seed=9)
    labels = np.array([0, 1, 1, 3, 0, 3])
    want_p, want_t = jax_mahal64.calibrate_mahalanobis(
        ff_jax, jnp.asarray(x), jnp.asarray(labels), 10, n=n, quantile=quantile)
    got_p, got_t = calibrate_mahalanobis(ff, torch.from_numpy(x), torch.from_numpy(labels), 10,
                                         n=n, quantile=quantile)
    assert isinstance(got_p, MahalanobisParams)
    assert got_t == pytest.approx(want_t, rel=1e-9, abs=0)
    _close(got_p.mean.numpy(), np.asarray(want_p.mean), 1e-9)
    _close(got_p.precision.numpy(), np.asarray(want_p.precision), 1e-9)
    with pytest.raises(ValueError, match="no calibration images"):
        calibrate_mahalanobis(ff, torch.from_numpy(x), torch.from_numpy(labels), 10, n=0)


def test_is_adversarial_flags_match(nets, jax_mahal64):
    (lf_jax, ff_jax), (lf, ff) = nets[np.float64]["jax"], nets[np.float64]["port"]
    x = _batch(np.float64, seed=10)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    # fitted on other images: the fitted ones' distances come in equal pairs
    labels = torch.tensor([0, 1, 2, 0, 1, 2])
    params, _ = calibrate_mahalanobis(ff, torch.from_numpy(_batch(np.float64, seed=12)),
                                      labels, 10)
    params_jax = jax_mahal64.MahalanobisParams(mean=jnp.asarray(params.mean.numpy()),
                                               precision=jnp.asarray(params.precision.numpy()))
    jax_scores = {"feature": jax_det.feature_score(ff_jax, xj),
                  "squeezing": jax_det.squeezing_score(lf_jax, xj),
                  "mahalanobis": jax_mahal64.mahalanobis_score(ff_jax, xj, params_jax)}
    for name, s_jax in jax_scores.items():
        thr = float(np.median(np.asarray(s_jax)))  # between scores: mixed flags
        with torch.no_grad():
            if name == "feature":
                want = jax_det.is_adversarial_by_feature(ff_jax, xj, thr)
                got = is_adversarial_by_feature(ff, xt, thr)
            elif name == "squeezing":
                want = jax_det.is_adversarial_by_squeezing(lf_jax, xj, thr)
                got = is_adversarial_by_squeezing(lf, xt, thr)
            else:
                want = jax_mahal64.is_adversarial_by_mahalanobis(ff_jax, xj, params_jax, thr)
                got = is_adversarial_by_mahalanobis(ff, xt, params, thr)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        assert 0 < int(got.sum()) < 6, name
