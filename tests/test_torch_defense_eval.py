"""The port's defenses, detector and attack -> defend -> detect cell against
the JAX package (CPU).

Smoothing and the quantization STE copy the JAX op order and are bit-exact
in float32.  The detector score reduces over H, W, C in another order, so it
is held at 1e-12 in float64 and 1e-5 relative in float32.  The fgsm cell runs
on bridged float64 resnet_tiny weights, plain and under each option
(adaptive, detector-aware, the squeezing and Mahalanobis detectors):
counters, x_adv and the summary lines must agree.
"""

import io
from contextlib import redirect_stdout

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
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.defenses import preprocess as jax_pre
from image_recognition_adversarial_example_attack_tpu.eval import defense_eval as jax_eval
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
    DefenseConfig, calibrate_feature_threshold, defend_input, defense_quantization,
    defense_smoothing, make_features_fn, score_from_features, threshold_from_scores)
from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
    STAT_KEYS, DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)

EPS = 8 / 255


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


def _images(shape=(3, 9, 11, 3), seed=0, lo=-0.1, hi=1.1):
    return np.random.RandomState(seed).uniform(lo, hi, size=shape).astype(np.float32)


def test_smoothing_bit_exact_float32():
    x = _images()
    want = np.asarray(jax_pre.defense_smoothing(jnp.asarray(x)))
    got = defense_smoothing(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantization_ste_forward_and_gradient():
    x = _images(seed=1)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    want = np.asarray(jax_pre.defense_quantization(jnp.asarray(x), 16))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = defense_quantization(xt, 16)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # straight-through: identity gradient inside [0,1], clip's zero outside
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.asarray(w) * jax_pre.defense_quantization(v, 16)))(jnp.asarray(x)))
    (got_g,) = torch.autograd.grad((torch.from_numpy(w) * got).sum(), xt)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    inside = (x > 0) & (x < 1)
    np.testing.assert_array_equal(got_g.numpy()[inside], w[inside])


def test_defend_input_bit_exact_float32():
    x = _images(seed=3)
    want = np.asarray(jax_pre.defend_input(jnp.asarray(x), jax_pre.DefenseConfig()))
    got = defend_input(torch.from_numpy(x), DefenseConfig()).numpy()
    np.testing.assert_array_equal(got, want)
    # an unknown JPEG codec is refused, as by the JAX package
    with pytest.raises(ValueError, match="unknown jpeg_mode"):
        jax_pre.defend_input(jnp.asarray(x), jax_pre.DefenseConfig(use_jpeg=True, jpeg_mode="x"))
    with pytest.raises(ValueError, match="unknown jpeg_mode"):
        defend_input(torch.from_numpy(x), DefenseConfig(use_jpeg=True, jpeg_mode="x"))


@pytest.mark.parametrize("shape", [(4, 5, 6, 16), (2, 2, 2, 256), (3, 14, 14, 1)])
def test_score_from_features(shape):
    f = np.random.RandomState(4).randn(*shape) * 3
    want64 = np.asarray(jax_det.score_from_features(jnp.asarray(f)))
    got64 = score_from_features(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got64, want64, rtol=1e-12, atol=0)
    f32 = f.astype(np.float32)
    want32 = np.asarray(jax_det.score_from_features(jnp.asarray(f32)))
    got32 = score_from_features(torch.from_numpy(f32)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=0)
    # the clip at 100
    big = score_from_features(torch.from_numpy(f * 1e4)).numpy()
    assert big.max() == 100.0
    # logits [B, K] (a model without a stage-3 split): their norm, as JAX's
    flat = f.reshape(shape[0], -1)
    np.testing.assert_allclose(score_from_features(torch.from_numpy(flat)).numpy(),
                               np.asarray(jax_det.score_from_features(jnp.asarray(flat))),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("scale", [0.01, 3.0, 40.0, 300.0])
@pytest.mark.parametrize("quantile", [0.5, 0.95])
def test_threshold_from_scores_and_rails(scale, quantile):
    """Linear quantile, halved above 50 and floored at 1.0."""
    s = np.random.RandomState(5).rand(37) * scale
    want = jax_det.threshold_from_scores(jnp.asarray(s), quantile)
    got = threshold_from_scores(torch.from_numpy(s), quantile)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.fixture(scope="module")
def cell():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=7)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        lf_jax = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        ff_jax = jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        x = np.random.RandomState(8).uniform(0.05, 0.95, size=(8, 32, 32, 3))
        y = np.asarray(lf_jax(jnp.asarray(x))).argmax(-1)
        y[::3] = (y[::3] + 1) % 10  # some clean mistakes, so every counter varies
    return {
        "jax": (lf_jax, ff_jax),
        "port": (make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                 make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)),
        "x": x, "y": y,
    }


def test_features_fn_matches(cell):
    want = np.asarray(cell["jax"][1](jnp.asarray(cell["x"])))
    got = cell["port"][1](torch.from_numpy(cell["x"])).numpy()
    assert got.shape == want.shape  # NHWC on both sides
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_calibration_prints_the_same_lines(cell):
    outs = []
    for thr_fn, ff, x in (
            (jax_det.calibrate_feature_threshold, cell["jax"][1], jnp.asarray(cell["x"])),
            (calibrate_feature_threshold, cell["port"][1], torch.from_numpy(cell["x"]))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            thr = thr_fn(ff, x, n=6, quantile=0.9)
        outs.append((buf.getvalue(), thr))
    assert outs[0][0] == outs[1][0]
    assert outs[1][1] == pytest.approx(outs[0][1], rel=1e-6)


@pytest.mark.parametrize("eps_override", [None, 4 / 255])
def test_fgsm_cell_matches(cell, eps_override):
    lf_jax, ff_jax = cell["jax"]
    lf, ff = cell["port"]
    x, y = cell["x"], cell["y"]
    scores = np.asarray(jax_det.score_from_features(ff_jax(jnp.asarray(x))))
    s = np.sort(scores)
    thr = float((s[3] + s[4]) / 2)  # between two clean scores: mixed flags
    kw = {} if eps_override is None else {"eps_override": eps_override}
    want = jax_eval.evaluate_defenses_batch(
        lf_jax, ff_jax, jnp.asarray(x), jnp.asarray(y), thr,
        jax_eval.DefenseEvalConfig(attack_name="fgsm", eps=EPS, alpha=2 / 255, steps=1),
        jax.random.PRNGKey(0), **kw)
    got = evaluate_defenses_batch(
        lf, ff, torch.from_numpy(x), torch.from_numpy(y), thr,
        DefenseEvalConfig(attack_name="fgsm", eps=EPS, alpha=2 / 255, steps=1), **kw)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["x_adv"].numpy(), np.asarray(want["x_adv"]),
                               rtol=0, atol=1e-9)
    stats, want_stats = aggregate_stats(got), jax_eval.aggregate_stats(want)
    assert stats == want_stats and stats["count"] == 8
    assert 0 < stats["detector_flags_clean"] < 8
    eps = EPS if eps_override is None else eps_override
    assert summary_line("fgsm", eps, stats) == jax_eval.summary_line("fgsm", eps, want_stats)


def test_summary_line_format():
    stats = aggregate_stats({k: torch.tensor([1, 0, 1]) for k in STAT_KEYS})
    assert stats == {**{k: 2 for k in STAT_KEYS}, "count": 3}
    assert summary_line("pgd", EPS, stats) == (
        "attack=pgd, eps=0.03137, attack_success=0.667, preproc_defense_acc=0.667, "
        "detector_clean_pass_rate=0.333, detector_adv_flag_rate=0.667, "
        "detector_attack_success=0.667")
    assert summary_line("pgd", EPS, stats) == jax_eval.summary_line("pgd", EPS, stats)


def _mahalanobis_params(cell):
    """The port's fit on the clean batch, and the same numbers for the JAX
    cell."""
    from image_recognition_adversarial_example_attack_tpu.defenses import (
        mahalanobis as jax_mahal)
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_mahalanobis)

    params, _ = calibrate_mahalanobis(cell["port"][1], torch.from_numpy(cell["x"]),
                                      torch.from_numpy(cell["y"]), 10)
    return params, jax_mahal.MahalanobisParams(mean=jnp.asarray(params.mean.numpy()),
                                               precision=jnp.asarray(params.precision.numpy()))


# each new option of the cell, and two together
CELL_OPTIONS = {
    "adaptive": {"adaptive": True},
    "detector_aware": {"detector_aware": True},
    "squeezing": {"detector": "squeezing"},
    "mahalanobis": {"detector": "mahalanobis"},
    "adaptive+detector_aware": {"adaptive": True, "detector_aware": True},
    "squeezing+detector_aware": {"detector": "squeezing", "detector_aware": True,
                                 "detector_lam": 3.0},
    "mahalanobis+detector_aware": {"detector": "mahalanobis", "detector_aware": True,
                                   "detector_margin": 0.5},
}


@pytest.mark.parametrize("option", sorted(CELL_OPTIONS))
def test_fgsm_cell_options_match(cell, option):
    """fgsm cells under each new option: the six counters, x_adv and the
    summary line equal the JAX package's."""
    lf_jax, ff_jax = cell["jax"]
    lf, ff = cell["port"]
    x, y = cell["x"], cell["y"]
    change = dict(CELL_OPTIONS[option])
    change_jax = dict(change)
    if change.get("detector") == "mahalanobis":
        change["detector_params"], change_jax["detector_params"] = _mahalanobis_params(cell)
    base = {"attack_name": "fgsm", "eps": EPS, "alpha": 2 / 255, "steps": 1}
    cfg_jax = jax_eval.DefenseEvalConfig(**base, **change_jax)
    cfg = DefenseEvalConfig(**base, **change)
    scores = np.asarray(jax_eval.make_detector_score_fn(lf_jax, ff_jax, cfg_jax)(jnp.asarray(x)))
    s = np.sort(scores)
    thr = float((s[3] + s[4]) / 2)  # between two clean scores: mixed flags
    want = jax_eval.evaluate_defenses_batch(lf_jax, ff_jax, jnp.asarray(x), jnp.asarray(y),
                                            thr, cfg_jax, jax.random.PRNGKey(0))
    got = evaluate_defenses_batch(lf, ff, torch.from_numpy(x), torch.from_numpy(y), thr, cfg)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["x_adv"].numpy(), np.asarray(want["x_adv"]),
                               rtol=0, atol=1e-9)
    stats, want_stats = aggregate_stats(got), jax_eval.aggregate_stats(want)
    assert stats == want_stats
    assert 0 < stats["detector_flags_clean"] < 8
    assert summary_line("fgsm", EPS, stats) == jax_eval.summary_line("fgsm", EPS, want_stats)


def test_options_change_the_attack(cell):
    """adaptive and detector_aware change x_adv (the options reach the
    attack), the detector alone does not."""
    lf, ff = cell["port"]
    x, y = torch.from_numpy(cell["x"]), torch.from_numpy(cell["y"])
    base = {"attack_name": "fgsm", "eps": EPS, "alpha": 2 / 255, "steps": 1}
    plain = evaluate_defenses_batch(lf, ff, x, y, 1.0, DefenseEvalConfig(**base))["x_adv"]
    for change, differs in (({"adaptive": True}, True),
                            ({"detector_aware": True, "detector_margin": 0.0}, True),
                            ({"detector": "squeezing"}, False)):
        got = evaluate_defenses_batch(lf, ff, x, y, 1.0,
                                      DefenseEvalConfig(**base, **change))["x_adv"]
        assert (not torch.equal(got, plain)) == differs, change


@pytest.mark.parametrize("attack", ["cw"])
def test_detector_aware_refuses_a_non_gradient_attack(cell, attack):
    lf, ff = cell["port"]
    cfg = DefenseEvalConfig(attack_name=attack, eps=EPS, alpha=2 / 255, steps=1, cw_steps=2,
                            detector_aware=True)
    with pytest.raises(ValueError, match="detector_aware"):
        evaluate_defenses_batch(lf, ff, torch.from_numpy(cell["x"]),
                                torch.from_numpy(cell["y"]), 1.0, cfg)


@pytest.mark.parametrize("detector,match", [("mahalanobis", "detector_params"),
                                            ("bogus", "unknown detector")])
def test_detector_refusals(cell, detector, match):
    lf, ff = cell["port"]
    cfg = DefenseEvalConfig(attack_name="fgsm", eps=EPS, alpha=2 / 255, steps=1,
                            detector=detector)
    with pytest.raises(ValueError, match=match):
        evaluate_defenses_batch(lf, ff, torch.from_numpy(cell["x"]),
                                torch.from_numpy(cell["y"]), 1.0, cfg)


def test_detector_params_are_left_out_of_the_comparison():
    a = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=2 / 255, steps=1,
                          detector_params=object())
    assert a == DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=2 / 255, steps=1)
