"""Train-mode BatchNorm (models/resnet.py::TrainableBatchNorm2d, the CIFAR
families' ``train_bn``) and precise-BN calibration
(train/adversarial.py::calibrate_batch_stats) against the JAX package's
(Flax ``BatchNorm(use_running_average=False)``) on the CPU.

Float64 throughout, both packages' float32 casts lifted
(``_torch_train_helpers.lifted_casts``):

- the train-mode forward of wrn_tiny and of a one-block PreActResNet, and
  one running-statistics update: within ``TOL = 1e-10`` (absolute);
- ``calibrate_batch_stats`` (momentum 0.9, biased variance, batches
  repeating): within 1e-10;
- PGD-AT steps under ``train_bn`` with crop-flip augmentation and with
  grad_accum (batch statistics per micro-batch): within ``TOL_STEP =
  1e-9``.

With ``train_bn`` off the layer is ``FrozenBatchNorm2d`` bit for bit, and
a family without ``train_bn`` is refused with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_helpers as H
from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import init_shaped
from _torch_scaleout_helpers import seeded_tree, seeded_variables
from image_recognition_adversarial_example_attack_tpu.core.normalize import (
    normalize_batch as jax_normalize)
from image_recognition_adversarial_example_attack_tpu.models import preactresnet as jax_preact
from image_recognition_adversarial_example_attack_tpu.models import resnet as jax_resnet
from image_recognition_adversarial_example_attack_tpu.models.zoo import ModelBundle as JaxBundle
from image_recognition_adversarial_example_attack_tpu.train import adversarial as jax_adv
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import normalize_batch
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.models import (preactresnet, resnet,
                                                                          wideresnet)
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import ModelBundle
from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

TOL, TOL_STEP = 1e-10, 1e-9
BASE = dict(eps=0.03, alpha=0.01, attack_steps=2, learning_rate=1e-2, weight_decay=1e-2,
            train_bn=True)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(13)
    return (rs.uniform(0.05, 0.95, (6, 32, 32, 3)), np.array([1, 2, 3, 4, 5, 6]),
            H.variables("wrn_tiny"))


def _flat_stats(tree, prefix=""):
    """Flax batch_stats -> {port buffer name: array}."""
    sd = from_jax_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, tree)},
                            "wideresnet" if "block1_0" in tree else "preactresnet")
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _preact_pair():
    module = jax_preact.PreActResNet(stage_sizes=(1, 1, 1, 1), dtype=jnp.float64)
    var = seeded_variables(preactresnet.PreActResNet(stage_sizes=(1, 1, 1, 1)), "preactresnet",
                           lambda t, rng: H._perturb(init_shaped(t, module), rng), seed=8)
    model = preactresnet.PreActResNet(stage_sizes=(1, 1, 1, 1), train_bn=True).double()
    model.requires_grad_(False)
    model.load_state_dict(from_jax_variables(var, "preactresnet"), strict=True)
    return module, var, model


@pytest.mark.parametrize("family", ["wrn_tiny", "preact_tiny"])
def test_train_mode_forward_and_statistics_equal_flaxs(family, data):
    """One train-mode forward: the logits, and each layer's running
    statistics after one Flax update (0.9 * running + 0.1 * batch, biased
    variance) against the port's ``batch_moments``."""
    x, _, var = data
    if family == "wrn_tiny":
        module = H.jax_module("wrn_tiny")
        model = resnet.set_train_bn(H.port_bundle("wrn_tiny", var).model, True)
    else:
        module, var, model = _preact_pair()
    mean, std = H.stats("wrn_tiny")
    with H.lifted_casts(), jax.enable_x64():
        out, upd = module.clone(train_bn=True).apply(
            var, jax_normalize(jnp.asarray(x), mean, std), mutable=["batch_stats"])
        want, want_stats = np.asarray(out), _flat_stats(upd["batch_stats"])
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, o, n=n: seen.__setitem__(n, resnet.batch_moments(inp[0])))
        for n, m in model.named_modules() if isinstance(m, resnet.TrainableBatchNorm2d)]
    got = model(normalize_batch(H.t(x), mean, std).permute(0, 3, 1, 2)).detach().numpy()
    for h in hooks:
        h.remove()
    assert np.abs(got - want).max() < TOL
    buffers = dict(model.named_buffers())
    assert len(seen) * 2 == len(want_stats)
    for name, (m, v) in seen.items():
        for leaf, stat in (("running_mean", m), ("running_var", v)):
            new = 0.9 * buffers[f"{name}.{leaf}"] + 0.1 * stat
            assert np.abs(new.numpy() - want_stats[f"{name}.{leaf}"]).max() < TOL


def test_train_bn_off_is_frozen_batchnorm_bit_for_bit():
    rs = np.random.RandomState(0)
    frozen, trainable = resnet.FrozenBatchNorm2d(5), resnet.TrainableBatchNorm2d(5)
    for m in (frozen, trainable):
        m.running_mean.copy_(torch.from_numpy(rs.randn(5).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rs.uniform(0.5, 2, 5).astype(np.float32)))
        m.weight.data.copy_(torch.from_numpy(rs.randn(5).astype(np.float32)))
    trainable.load_state_dict(frozen.state_dict())
    x = torch.from_numpy(rs.randn(3, 5, 4, 4).astype(np.float32))
    assert torch.equal(frozen(x), trainable(x))
    model = wideresnet.wrn_tiny()
    assert not model.train_bn
    assert all(not m.train_bn for m in model.modules()
               if isinstance(m, resnet.TrainableBatchNorm2d))
    assert resnet.set_train_bn(model, True) is model and model.train_bn
    assert all(m.train_bn for m in model.modules() if isinstance(m, resnet.TrainableBatchNorm2d))
    assert wideresnet.WideResNet(depth=10, widen=1, train_bn=True).bn1.train_bn


def test_train_bn_is_refused_for_a_family_without_it(data):
    x, _, _ = data
    module = jax_resnet.resnet_tiny(num_classes=10)
    var = init_shaped(seeded_tree(resnet.resnet_tiny(num_classes=10), "resnet"), module)
    jb = JaxBundle(name="resnet_tiny", module=module, variables=var, source="random",
                   input_size=32)
    with pytest.raises(ValueError) as theirs:
        jax_adv.train_state_from_bundle(jb, jax_adv.AdvTrainConfig(train_bn=True))
    model = resnet.resnet_tiny().requires_grad_(False)
    pb = ModelBundle(name="resnet_tiny", model=model, source="random", dtype=torch.float32,
                     device=torch.device("cpu"), input_size=32)
    with pytest.raises(ValueError) as ours:
        adversarial.train_state_from_bundle(pb, adversarial.AdvTrainConfig(train_bn=True))
    assert str(ours.value) == str(theirs.value) and "train_bn" in str(ours.value)


def test_calibrate_batch_stats_equals_jaxs(data):
    """Precise-BN over 6 images in batches of 4 (one full batch, repeated to
    ``min_batches`` 5) against the EMA parameters, then the export's
    running statistics."""
    x, y, var = data
    kw = dict(BASE, ema_decay=0.5)
    mean, std = H.stats("wrn_tiny")
    key = jax.random.PRNGKey(2)
    with H.lifted_casts():
        with jax.enable_x64():
            jcfg = jax_adv.AdvTrainConfig(**kw)
            js = jax_adv.train_state_from_bundle(H.jax_bundle("wrn_tiny", var), jcfg)
            js, _ = jax.jit(jax_adv.make_train_step(jcfg, mean, std))(
                js, jnp.asarray(x), jnp.asarray(y), key)
            want = jax_adv.calibrate_batch_stats(js, jnp.asarray(x), mean, std, batch_size=4,
                                                 min_batches=5)
            want = _flat_stats(want["batch_stats"])
        pcfg = adversarial.AdvTrainConfig(**kw)
        port = H.carry(adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var), pcfg),
                       js)
        got = adversarial.calibrate_batch_stats(port, H.t(x), mean, std, batch_size=4,
                                                min_batches=5)
    for k, v in want.items():
        assert np.abs(got[k].numpy() - v).max() < TOL, k
        assert np.abs(v - port.extra_variables[k].numpy()).max() > 1e-3  # moved
    # without train_bn there is nothing to calibrate
    plain = adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var),
                                                adversarial.AdvTrainConfig())
    assert adversarial.calibrate_batch_stats(plain, H.t(x)) is plain.extra_variables


@pytest.mark.parametrize("extra", [dict(aug_pad=4, aug_flip=True), dict(grad_accum=2)],
                         ids=["crop-flip", "grad_accum"])
def test_train_bn_steps_equal_jaxs(extra, data, monkeypatch):
    """Two PGD-AT steps under train_bn (the inner attack's forwards on batch
    statistics too), and the train-mode clean accuracy after them."""
    x, y, var = data
    x, y = x[:4], y[:4]
    kw = {**BASE, **extra}
    mean, std = H.stats("wrn_tiny")
    keys = [jax.random.PRNGKey(90), jax.random.PRNGKey(91)]
    with H.lifted_casts():
        with jax.enable_x64():
            jcfg = jax_adv.AdvTrainConfig(**kw)
            js = jax_adv.train_state_from_bundle(H.jax_bundle("wrn_tiny", var), jcfg)
            jstep = jax.jit(jax_adv.make_train_step(jcfg, mean, std))
        pcfg = adversarial.AdvTrainConfig(**kw)
        state = H.carry(adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var),
                                                            pcfg), js)
        assert state.train_bn and state.model.train_bn
        pstep = adversarial.make_train_step(pcfg, mean, std)
        feeder = H.Feeder(monkeypatch)
        for k in keys:
            with jax.enable_x64():
                js, jm = jstep(js, jnp.asarray(x), jnp.asarray(y), k)
            feeder.add(H.step_draws("pgd-at", jcfg, k, x.shape))
            state, m = pstep(state, H.t(x), H.t(y), generator_from_seed(0))
            assert feeder.empty()
            assert H.max_diff(state.params, js.params) < TOL_STEP
            for name in jm:
                assert abs(float(m[name]) - float(jm[name])) < TOL_STEP
        with jax.enable_x64():
            want = float(jax.jit(jax_adv.make_eval_step(mean, std))(
                js, jnp.asarray(x), jnp.asarray(y))["clean_accuracy"])
        got = float(adversarial.make_eval_step(mean, std)(state, H.t(x), H.t(y))["clean_accuracy"])
    assert got == want
    # training leaves the running statistics as they were
    for k, v in state.extra_variables.items():
        assert np.array_equal(v.numpy(), _flat_stats(js.extra_variables["batch_stats"]).get(
            k, v.numpy()))
