"""The port's CW-L2 attack against the JAX package's (CPU).

Both sides run resnet_tiny with the same bridged float64 weights, so the
discrete decisions of the attack (success, best-L2 tracking) cannot flip on
rounding noise: x_adv agrees to 1e-9 and success exactly.  Also the dispatch,
a cw cell of ``evaluate_defenses_batch``, the classify CLI and the defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import cw as jax_cw
from image_recognition_adversarial_example_attack_tpu.cli import classify as jax_classify
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.eval import defense_eval as jax_eval
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    AttackParams, cw_l2_attack, make_logits_fn, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.cli import classify
from image_recognition_adversarial_example_attack_tpu_torch.core import images
from image_recognition_adversarial_example_attack_tpu_torch.defenses import make_features_fn
from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
    STAT_KEYS, DefenseEvalConfig, evaluate_defenses_batch)

CW = {"c": 5.0, "kappa": 0.0, "steps": 12, "lr": 0.05}


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=3)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        lf_jax = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        ff_jax = jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        x = np.random.RandomState(12).uniform(0.0, 1.0, size=(6, 32, 32, 3))
        x[0, :4] = 1.0  # saturated pixels: atanh at the clip
        x[1, :, :4] = 0.0
        y = np.asarray(lf_jax(jnp.asarray(x))).argmax(-1)
    return {"jax": (lf_jax, ff_jax),
            "port": (make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                     make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)),
            "x": x, "y": y}


@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("kappa", [0.0, 2.0])
def test_cw_matches_jax(setup, targeted, kappa):
    lf_jax, lf = setup["jax"][0], setup["port"][0]
    x, y = setup["x"], setup["y"]
    y_t = (y + 3) % 10 if targeted else None
    kw = {**CW, "kappa": kappa, "targeted": targeted}
    want = jax_cw.cw_l2_attack(lf_jax, jnp.asarray(x), jnp.asarray(y),
                               y_target=None if y_t is None else jnp.asarray(y_t), **kw)
    got = cw_l2_attack(lf, torch.from_numpy(x), torch.from_numpy(y),
                       y_target=None if y_t is None else torch.from_numpy(y_t), **kw)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got.x_adv.numpy(), np.asarray(want.x_adv), rtol=0, atol=1e-9)
    assert got.x_adv.dtype == torch.float64
    assert got.x_adv.min() >= 0.0 and got.x_adv.max() <= 1.0
    # the attack did something: some samples succeed, and those are
    # misclassified (or hit the target) at the returned image
    assert bool(got.success.any())
    pred = lf(got.x_adv).argmax(-1).numpy()
    s = got.success.numpy()
    if targeted:
        assert (pred[s] == y_t[s]).all()
    else:
        assert (pred[s] != y[s]).all()


def test_cw_needs_a_target_when_targeted(setup):
    with pytest.raises(ValueError, match="y_target"):
        cw_l2_attack(setup["port"][0], torch.from_numpy(setup["x"]),
                     torch.from_numpy(setup["y"]), targeted=True, steps=1)


@pytest.mark.parametrize("targeted", [False, True])
def test_run_attack_cw_dispatch(setup, targeted):
    lf_jax, lf = setup["jax"][0], setup["port"][0]
    x, y = setup["x"], setup["y"]
    y_t = (y + 1) % 10 if targeted else None
    kw = {"cw_c": 3.0, "cw_kappa": 0.5, "cw_steps": 6, "cw_lr": 0.03}
    want = jax_api.run_attack("cw", lf_jax, jnp.asarray(x), jnp.asarray(y),
                              jax_api.AttackParams(**kw), jax.random.PRNGKey(0),
                              y_target=None if y_t is None else jnp.asarray(y_t))
    yt_t = None if y_t is None else torch.from_numpy(y_t)
    got = run_attack("cw", lf, torch.from_numpy(x), torch.from_numpy(y), AttackParams(**kw),
                     y_target=yt_t)
    direct = cw_l2_attack(lf, torch.from_numpy(x), torch.from_numpy(y), c=3.0, kappa=0.5,
                          steps=6, lr=0.03, targeted=targeted, y_target=yt_t).x_adv
    assert torch.equal(got, direct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)


def test_cw_defaults_match_jax():
    p, jp = AttackParams(), jax_api.AttackParams()
    assert (p.cw_c, p.cw_kappa, p.cw_steps, p.cw_lr) == (
        jp.cw_c, jp.cw_kappa, jp.cw_steps, jp.cw_lr)
    c = DefenseEvalConfig(attack_name="cw", eps=0.1, alpha=0.1, steps=1)
    jc = jax_eval.DefenseEvalConfig(attack_name="cw", eps=0.1, alpha=0.1, steps=1)
    assert (c.cw_c, c.cw_kappa, c.cw_steps, c.cw_lr) == (
        jc.cw_c, jc.cw_kappa, jc.cw_steps, jc.cw_lr)
    cp = DefenseEvalConfig(attack_name="cw", eps=0.1, alpha=0.1, steps=1, cw_c=2.0,
                           cw_kappa=1.0, cw_steps=7, cw_lr=0.5).attack_params()
    assert (cp.cw_c, cp.cw_kappa, cp.cw_steps, cp.cw_lr) == (2.0, 1.0, 7, 0.5)
    args = classify.build_parser().parse_args(["x.png"])
    jargs = jax_classify.build_parser().parse_args(["x.png"])
    for k in ("cw_c", "cw_kappa", "cw_steps", "cw_lr"):
        assert getattr(args, k) == getattr(jargs, k), k


def test_cw_cell_matches(setup):
    (lf_jax, ff_jax), (lf, ff) = setup["jax"], setup["port"]
    x, y = setup["x"], setup["y"]
    scores = np.sort(np.asarray(jax_det.score_from_features(ff_jax(jnp.asarray(x)))))
    thr = float((scores[2] + scores[3]) / 2)
    kw = {"attack_name": "cw", "eps": 8 / 255, "alpha": 2 / 255, "steps": 1,
          "cw_c": 5.0, "cw_steps": 8, "cw_lr": 0.05}
    want = jax_eval.evaluate_defenses_batch(
        lf_jax, ff_jax, jnp.asarray(x), jnp.asarray(y), thr,
        jax_eval.DefenseEvalConfig(**kw), jax.random.PRNGKey(0))
    got = evaluate_defenses_batch(lf, ff, torch.from_numpy(x), torch.from_numpy(y), thr,
                                  DefenseEvalConfig(**kw))
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["x_adv"].numpy(), np.asarray(want["x_adv"]),
                               rtol=0, atol=1e-9)
    assert int(got["attack_success"].sum()) > 0


def test_classify_cw_on_cpu(tmp_path, capsys):
    rng = np.random.RandomState(0)
    img = tmp_path / "in.png"
    images.save_image_01(rng.rand(40, 50, 3).astype(np.float32), img)
    adv = tmp_path / "adv.png"
    rc = classify.main([str(img), "--attack", "cw", "--device", "cpu", "--model",
                        "resnet_tiny", "--cw_steps", "3", "--cw_c", "2", "--save_adv", str(adv)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Clean:" in out and "Adversarial (cw):" in out
    assert out.count("Top 1: ") == 2
    saved = np.asarray(images.load_image(adv, size=224))[0]
    assert saved.shape == (224, 224, 3) and 0.0 <= saved.min() and saved.max() <= 1.0
