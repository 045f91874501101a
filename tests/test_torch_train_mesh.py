"""The port's training step over a data-sharded batch (train/adversarial.py on
a ``[cpu] * 8`` 4x2 mesh) against its unsharded step and against the JAX
package's step jitted over its own 4x2 mesh (tests/test_train.py:105-131 and
:490-515).

wrn_tiny in float64 with both packages' float32 casts lifted
(``_torch_train_helpers.lifted_casts``).  The port's sharded step draws
through ``core.rng.shard_generators`` and so makes the unsharded step's
draws (held bit for bit); against JAX, JAX's draws are fed through the
port's draw functions, each shard taking its rows.  Tolerances are JAX's
(loss rtol 1e-5, parameters rtol 1e-5 / atol 1e-6): plain PGD-AT,
``grad_accum=2`` with remat, and ``train_bn`` (each micro-batch's
statistics, summed over the shards) with ``grad_accum=2``.
TRADES, MART and free-AT sharded equal their unsharded steps (also eight
lockstep shards switching every microsecond), and remat with ``train_bn``
on a sharded batch is refused.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_train_helpers as H
from _torch_scaleout_helpers import seeded_variables
from image_recognition_adversarial_example_attack_tpu.parallel import mesh as jax_mesh
from image_recognition_adversarial_example_attack_tpu.train import adversarial as jax_adv
from image_recognition_adversarial_example_attack_tpu_torch.attacks import pgd
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
    generator_from_seed, whole_batch_draw)
from image_recognition_adversarial_example_attack_tpu_torch.models.wideresnet import wrn_tiny
from image_recognition_adversarial_example_attack_tpu_torch.parallel import make_mesh, shard_batch
from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

CPU = torch.device("cpu")
CASES = {
    "plain": dict(attack_steps=2),
    "grad_accum+remat": dict(attack_steps=2, grad_accum=2, remat=True),
    "train_bn+grad_accum": dict(attack_steps=2, train_bn=True, grad_accum=2),
}
BASE = dict(eps=8 / 255, alpha=2 / 255, learning_rate=5e-3)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    return (rs.rand(16, 16, 16, 3), rs.randint(0, 10, 16),
            seeded_variables(wrn_tiny(), "wideresnet", H._perturb))


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(n_data=4, n_model=2, devices=[CPU] * 8)


def _port_state(cfg, var):
    return adversarial.train_state_from_bundle(H.port_bundle("wrn_tiny", var), cfg)


def _max_rel(a: dict, b: dict) -> None:
    for k, v in b.items():
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded_and_jaxs_4x2(case, data, mesh8, monkeypatch):
    x, y, var = data
    kw = {**BASE, **CASES[case]}
    key = jax.random.PRNGKey(5)
    jmesh = jax_mesh.make_mesh(n_data=4, n_model=2)
    xs = NamedSharding(jmesh, JP("data"))
    with H.lifted_casts():
        cfg_j = jax_adv.AdvTrainConfig(**kw)
        with jax.enable_x64():
            state0 = jax_adv.train_state_from_bundle(H.jax_bundle("wrn_tiny", var), cfg_j)
            step_j = jax.jit(jax_adv.make_train_step(cfg_j, *H.stats("wrn_tiny")),
                             in_shardings=(None, xs, xs, None), out_shardings=(None, None))
            js, jm = step_j(state0, jax.device_put(jnp.asarray(x), xs),
                            jax.device_put(jnp.asarray(y), xs), key)
        cfg = adversarial.AdvTrainConfig(**kw)
        step = adversarial.make_train_step(cfg, *H.stats("wrn_tiny"))
        # the port's own draws: sharded against unsharded
        one, m1 = step(_port_state(cfg, var), H.t(x), H.t(y), generator_from_seed(3))
        got, m2 = step(_port_state(cfg, var), shard_batch(x, mesh8), y, generator_from_seed(3))
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-12)
        _max_rel(got.params, one.params)
        # JAX's draws, each shard taking its rows of each micro-batch's draw
        starts = H.step_draws("pgd-at", cfg, key, x.shape)["start"]

        def fed(shape, eps, generator, device):
            whole = whole_batch_draw(generator, lambda p: starts.pop(0))
            return whole[generator.lo:generator.hi]

        monkeypatch.setattr(pgd, "draw_start", fed)
        port = H.carry(_port_state(cfg, var), state0)
        fed_state, m3 = step(port, shard_batch(x, mesh8), y, generator_from_seed(3))
    assert not starts
    np.testing.assert_allclose(float(m3["loss"]), float(jm["loss"]), rtol=1e-5)
    want = H.port_params(js.params)
    _max_rel(fed_state.params, {k: torch.from_numpy(v) for k, v in want.items()})
    assert fed_state.step == int(js.step) == 1


@pytest.mark.parametrize("objective", ["trades", "mart", "free"])
def test_sharded_objectives_equal_unsharded(objective, data, mesh8):
    x, y, var = data
    kw = {**BASE, "attack_steps": 2, "free_replays": 2,
          "train_bn": objective != "mart", "aug_pad": 2 if objective == "trades" else 0,
          "aug_flip": objective == "trades"}
    with H.lifted_casts():
        cfg = adversarial.AdvTrainConfig(**kw)
        make = {"trades": adversarial.make_trades_step, "mart": adversarial.make_mart_step,
                "free": adversarial.make_free_step}[objective]
        step = make(cfg, *H.stats("wrn_tiny"))
        extra = (torch.zeros(x.shape, dtype=torch.float64),) if objective == "free" else ()
        one = step(_port_state(cfg, var), H.t(x), H.t(y), generator_from_seed(4), *extra)
        got = step(_port_state(cfg, var), shard_batch(x, mesh8), y, generator_from_seed(4),
                   *extra)
    for k in one[1]:
        np.testing.assert_allclose(float(got[1][k]), float(one[1][k]), rtol=1e-10, atol=1e-12)
    _max_rel(got[0].params, one[0].params)
    if objective == "free":
        np.testing.assert_allclose(got[2].gather().numpy(), one[2].numpy(), rtol=0, atol=1e-12)


def test_lockstep_shards_under_a_short_switch_interval(data):
    """train_bn's eight lockstep threads (more than this host gives the test
    process), switching every microsecond: the shared draws and the summed
    statistics still give the unsharded step."""
    x, y, var = data
    cfg = adversarial.AdvTrainConfig(**BASE, attack_steps=1, train_bn=True)
    step = adversarial.make_train_step(cfg, *H.stats("wrn_tiny"))
    mesh = make_mesh(n_data=8, n_model=1, devices=[CPU] * 8)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with H.lifted_casts():
            one, _ = step(_port_state(cfg, var), H.t(x), H.t(y), generator_from_seed(8))
            got, _ = step(_port_state(cfg, var), shard_batch(x, mesh), y, generator_from_seed(8))
    finally:
        sys.setswitchinterval(prev)
    _max_rel(got.params, one.params)


def test_remat_with_train_bn_on_a_sharded_batch_is_refused(data, mesh8):
    x, y, var = data
    cfg = adversarial.AdvTrainConfig(**BASE, attack_steps=1, train_bn=True, remat=True)
    step = adversarial.make_train_step(cfg, *H.stats("wrn_tiny"))
    with pytest.raises(NotImplementedError, match="remat with train_bn"):
        step(_port_state(cfg, var), shard_batch(x, mesh8), y, generator_from_seed(0))


def test_a_micro_batch_smaller_than_the_data_axis_is_refused(data, mesh8):
    x, y, var = data
    cfg = adversarial.AdvTrainConfig(**BASE, attack_steps=1, grad_accum=4)
    step = adversarial.make_train_step(cfg, *H.stats("wrn_tiny"))
    mesh = make_mesh(n_data=8, n_model=1, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="micro-batch of 4 rows"):
        step(_port_state(cfg, var), shard_batch(x, mesh), y, generator_from_seed(0))
