"""The port's detector-aware PGD and FGSM against the JAX package (CPU).

Bridged float64 resnet_tiny weights, with logits and features kept in
float64 on both sides (``uncast_fns``), so that the sign of each gradient
element is decided the same way: the iterates agree to 1e-12.  With
``lam == 0`` the attack is bit-equal to the port's ``pgd_linf_attack``
from the same generator, the guarantee ``tests/test_detector_aware.py``
gives the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import detector_aware as jax_da
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    detector_aware_fgsm, detector_aware_pgd, make_logits_fn, pgd_linf_attack)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
    score_from_features, squeezing_score)

EPS, ALPHA = 8 / 255, 2 / 255


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


@pytest.fixture(scope="module")
def net():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=13)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(14).uniform(0.05, 0.95, size=(6, 32, 32, 3))
        y = np.asarray(jax.jit(fns["jax"][0])(jnp.asarray(x))).argmax(-1)
    return {"fns": fns, "x": x, "y": y, "variables": variables}


def _scores(fns, detector):
    (lf_jax, ff_jax), (lf, ff) = fns["jax"], fns["port"]
    if detector == "feature":
        return (lambda xx: jax_det.score_from_features(ff_jax(xx)),
                lambda xx: score_from_features(ff(xx)))
    return (lambda xx: jax_det.squeezing_score(lf_jax, xx),
            lambda xx: squeezing_score(lf, xx))


def _threshold(score_jax, x):
    """The clean scores' median over the margin: the hinge is active on
    about half of the batch."""
    return float(np.median(np.asarray(score_jax(jnp.asarray(x))))) / 0.9


@pytest.mark.parametrize("detector", ["feature", "squeezing"])
def test_detector_aware_pgd_matches(net, detector):
    (lf_jax, _), (lf, _) = net["fns"]["jax"], net["fns"]["port"]
    s_jax, s_port = _scores(net["fns"], detector)
    x, y = net["x"], net["y"]
    thr = _threshold(s_jax, x)
    kw = {"eps": EPS, "alpha": ALPHA, "steps": 3, "threshold": thr, "lam": 1.0,
          "margin": 0.9, "random_start": False}
    want = np.asarray(jax_da.detector_aware_pgd(
        lf_jax, s_jax, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(0), **kw))
    got = detector_aware_pgd(lf, s_port, torch.from_numpy(x), torch.from_numpy(y),
                             generator=None, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the penalty is active: the result is not the plain attack's
    plain = detector_aware_pgd(lf, s_port, torch.from_numpy(x), torch.from_numpy(y),
                               generator=None, **{**kw, "lam": 0.0}).numpy()
    assert not np.array_equal(got, plain)


@pytest.mark.parametrize("detector", ["feature", "squeezing"])
def test_detector_aware_fgsm_matches(net, detector):
    (lf_jax, _), (lf, _) = net["fns"]["jax"], net["fns"]["port"]
    s_jax, s_port = _scores(net["fns"], detector)
    x, y = net["x"], net["y"]
    kw = {"eps": EPS, "threshold": _threshold(s_jax, x), "lam": 2.0, "margin": 0.9}
    want = np.asarray(jax_da.detector_aware_fgsm(lf_jax, s_jax, jnp.asarray(x),
                                                 jnp.asarray(y), **kw))
    got = detector_aware_fgsm(lf, s_port, torch.from_numpy(x), torch.from_numpy(y),
                              **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(got - x).max() <= EPS + 1e-12


def test_lam_zero_is_pgd_bit_for_bit(net):
    lf = net["fns"]["port"][0]
    x, y = torch.from_numpy(net["x"]), torch.from_numpy(net["y"])
    _, s_port = _scores(net["fns"], "feature")
    a = detector_aware_pgd(lf, s_port, x, y, eps=EPS, alpha=ALPHA, steps=4,
                           generator=generator_from_seed(5), threshold=1.0, lam=0.0)
    b = pgd_linf_attack(lf, x, y, eps=EPS, alpha=ALPHA, steps=4,
                        generator=generator_from_seed(5))
    assert torch.equal(a, b)


def _toy_score(xx):
    # smooth and differentiable: mean squared distance from mid-gray
    return 10.0 * torch.mean(torch.square(xx - 0.5), dim=(1, 2, 3))


def test_ball_range_and_penalty(net):
    """Inside the eps-ball and [0,1] with a large penalty; against a score
    that is penalized everywhere the aware attack ends lower than the
    oblivious one."""
    model = port_resnet("resnet_tiny", net["variables"], np.float32, num_classes=10)
    lf = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)
    x = torch.from_numpy(net["x"]).float()
    y = torch.from_numpy(net["y"])
    x_adv = detector_aware_pgd(lf, _toy_score, x, y, eps=EPS, alpha=ALPHA, steps=5,
                               generator=generator_from_seed(1), threshold=0.1, lam=5.0)
    assert x_adv.dtype == torch.float32
    assert float((x_adv - x).abs().max()) <= EPS + 1e-6
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0
    aware = detector_aware_pgd(lf, _toy_score, x, y, eps=EPS, alpha=ALPHA, steps=10,
                               generator=generator_from_seed(2), threshold=0.0,
                               lam=100.0, margin=1.0)
    oblivious = pgd_linf_attack(lf, x, y, eps=EPS, alpha=ALPHA, steps=10,
                                generator=generator_from_seed(2))
    assert float(_toy_score(aware).mean()) < float(_toy_score(oblivious).mean())
