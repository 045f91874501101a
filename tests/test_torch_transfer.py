"""The port's transfer evaluation (eval/transfer.py, the ensemble of
attacks/api.py, eval/streaming.py::stream_transfer_cell) against the JAX
package on the CPU.

The source and the two targets are resnet_tiny with bridged float64 weights
on both sides (three seeds), so no sign or argmax decision flips on rounding
noise: success vectors agree exactly and ``x_adv`` within 1e-10.  pgd's
random start draws other bits than JAX's (a known deviation), so pgd is
held to the JAX package only without the random start, and with it to the
eps-ball and [0, 1]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.eval import streaming as jax_streaming
from image_recognition_adversarial_example_attack_tpu.eval import transfer as jax_transfer
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    AttackParams, make_ensemble_logits_fn, make_logits_fn)
from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
    make_placer, stream_transfer_cell)
from image_recognition_adversarial_example_attack_tpu_torch.eval.transfer import (
    TransferCell, asr, transfer_attack_batch)

EPS = 6 / 255
PARAMS = dict(eps=EPS, alpha=2 / 255, steps=3, cw_c=5.0, cw_steps=6, cw_lr=0.05)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


@pytest.fixture(scope="module")
def fns():
    """{"jax"|"port": (source, {target name: logits fn})}, float64 weights."""
    out = {"jax": [None, {}], "port": [None, {}]}
    with jax.enable_x64():
        for role, seed in (("source", 3), ("t1", 4), ("t2", 5)):
            module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=seed)
            model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
            jf = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
            pf = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)
            if role == "source":
                out["jax"][0], out["port"][0] = jf, pf
            else:
                out["jax"][1][role], out["port"][1][role] = jf, pf
    return out


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(7).uniform(0.0, 1.0, size=(6, 32, 32, 3))


def _port_cell(fns, x, attack, convention, **kw):
    src, tgts = fns["port"]
    return transfer_attack_batch(src, tgts, torch.from_numpy(x), attack,
                                 AttackParams(**{**PARAMS, **kw}), generator_from_seed(0),
                                 convention=convention)


def _jax_cell(fns, x, attack, convention, **kw):
    src, tgts = fns["jax"]
    return jax_transfer.transfer_attack_batch(
        src, tgts, jnp.asarray(x), attack, jax_api.AttackParams(**{**PARAMS, **kw}),
        jax.random.PRNGKey(0), convention=convention)


def _assert_same(ours: TransferCell, theirs) -> None:
    np.testing.assert_array_equal(ours.source_success.numpy(), np.asarray(theirs.source_success))
    assert ours.target_success.keys() == theirs.target_success.keys()
    for name, v in ours.target_success.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs.target_success[name]))
    np.testing.assert_allclose(ours.x_adv.numpy(), np.asarray(theirs.x_adv), rtol=0, atol=1e-10)


@pytest.mark.parametrize("convention", ["source-label", "blackbox"])
@pytest.mark.parametrize("attack", ["fgsm", "cw"])
def test_transfer_cell_matches_jax(fns, x, attack, convention):
    ours = _port_cell(fns, x, attack, convention)
    _assert_same(ours, _jax_cell(fns, x, attack, convention))
    assert ours.source_success.dtype == torch.int32
    assert 0 < int(ours.source_success.sum())  # the attack flipped something


@pytest.mark.parametrize("convention", ["source-label", "blackbox"])
def test_pgd_without_random_start_matches_jax(fns, x, convention):
    _assert_same(_port_cell(fns, x, "pgd", convention, random_start=False),
                 _jax_cell(fns, x, "pgd", convention, random_start=False))


def test_pgd_with_random_start_stays_in_the_ball(fns, x):
    cell = _port_cell(fns, x, "pgd", "source-label")
    xt = torch.from_numpy(x)
    assert float((cell.x_adv - xt).abs().max()) <= EPS + 1e-9
    assert float(cell.x_adv.min()) >= 0.0 and float(cell.x_adv.max()) <= 1.0
    for v in (cell.source_success, *cell.target_success.values()):
        assert v.shape == (6,) and set(v.tolist()) <= {0, 1}
    again = _port_cell(fns, x, "pgd", "source-label")  # the same generator, the same cell
    assert torch.equal(cell.x_adv, again.x_adv)


def test_unknown_convention_raises(fns, x):
    with pytest.raises(ValueError, match="unknown transfer convention"):
        _port_cell(fns, x, "fgsm", "target-label")


@pytest.mark.parametrize("weights", [None, [1.0, 3.0]])
def test_ensemble_matches_jax(fns, x, weights):
    members = [fns["port"][0], fns["port"][1]["t1"]]
    jax_members = [fns["jax"][0], fns["jax"][1]["t1"]]
    ours = make_ensemble_logits_fn(members, weights)(torch.from_numpy(x))
    theirs = jax_api.make_ensemble_logits_fn(jax_members, weights)(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-6)
    # and a cell attacking the ensemble
    src = make_ensemble_logits_fn(members, weights)
    cell = transfer_attack_batch(src, {"t2": fns["port"][1]["t2"]}, torch.from_numpy(x), "fgsm",
                                 AttackParams(**PARAMS))
    want = jax_transfer.transfer_attack_batch(
        jax_api.make_ensemble_logits_fn(jax_members, weights), {"t2": fns["jax"][1]["t2"]},
        jnp.asarray(x), "fgsm", jax_api.AttackParams(**PARAMS), jax.random.PRNGKey(0))
    _assert_same(cell, want)


@pytest.mark.parametrize("case,match", [
    ("empty", "at least one member"), ("count", "2 weights for 1 members"),
    ("sum", "sum to a positive value"), ("shape", "disagree on logits shape")])
def test_ensemble_refusals_are_jaxs(case, match):
    f10 = lambda t: torch.zeros(t.shape[0], 10)  # noqa: E731
    f5 = lambda t: torch.zeros(t.shape[0], 5)  # noqa: E731
    args = {"empty": ([], None), "count": ([f10], [1.0, 2.0]), "sum": ([f10, f10], [1.0, -1.0]),
            "shape": ([f10, f5], None)}[case]
    with pytest.raises(ValueError, match=match):
        make_ensemble_logits_fn(*args)(torch.zeros(2, 4, 4, 3))
    jargs = {"shape": ([lambda t: jnp.zeros((t.shape[0], 10)),
                        lambda t: jnp.zeros((t.shape[0], 5))], None)}.get(case, args)
    with pytest.raises(ValueError, match=match):
        jax_api.make_ensemble_logits_fn(*jargs)(jnp.zeros((2, 4, 4, 3)))


@pytest.mark.parametrize("vec,n_valid,want", [
    ([1, 0, 1, 1], None, 0.75), ([1, 0, 1, 1], 2, 0.5), ([], None, 0.0),
    (np.array([0, 0, 1], np.int32), 3, 1 / 3)])
def test_asr(vec, n_valid, want):
    assert asr(torch.tensor(vec, dtype=torch.int32), n_valid) == pytest.approx(want)
    assert asr(vec, n_valid) == jax_transfer.asr(np.asarray(vec, np.int32), n_valid)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("transfer_imgs")
    rs = np.random.RandomState(2)
    paths = []
    for i in range(5):
        paths.append(d / f"img_{i}.png")
        Image.fromarray((rs.rand(40, 48, 3) * 255).astype(np.uint8)).save(paths[-1])
    return paths


def test_streamed_cell_equals_the_resident_and_jaxs(fns, pngs, tmp_path):
    """fgsm over 5 images in chunks of 2 (the last padded, 1 valid): the
    record equals the one-batch cell's and the JAX streamed record; the kept
    adversarial rows are saved once each."""
    src, tgts = fns["port"]
    names = list(tgts)

    def cell_fn(xx, g, eps):
        return transfer_attack_batch(lambda t: src(t.double()),
                                     {n: (lambda t, f=f: f(t.double())) for n, f in tgts.items()},
                                     xx, "fgsm", AttackParams(**{**PARAMS, "eps": eps}), g)

    saved = []
    ours = stream_transfer_cell(cell_fn, pngs, seed=0, cell_id="fgsm:x", eps=EPS,
                                target_names=names, chunk_size=2, place=make_placer("cpu"),
                                size=32, save_adv=lambda a, p: saved.append((a.shape, p)))
    resident = cell_fn(torch.from_numpy(load_image_batch(pngs, size=32)), None, EPS)
    assert ours == {"source_success": resident.source_success.tolist(),
                    "transfer_success": {n: v.tolist()
                                         for n, v in resident.target_success.items()}}
    assert [s for s, _ in saved] == [(2, 32, 32, 3), (2, 32, 32, 3), (1, 32, 32, 3)]
    assert [str(p) for _, ps in saved for p in ps] == [str(p) for p in pngs]

    jsrc, jtgts = fns["jax"]

    def jax_cell(xx, key, eps):
        return jax_transfer.transfer_attack_batch(
            jsrc, jtgts, xx, "fgsm", jax_api.AttackParams(**{**PARAMS, "eps": float(eps)}), key)

    theirs = jax_streaming.stream_transfer_cell(jax_cell, pngs, jax.random.PRNGKey(0), EPS,
                                                names, chunk_size=2, size=32)
    assert ours == theirs
