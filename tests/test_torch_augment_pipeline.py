"""The port's training augmentation (train/augment.py) and training data
pipeline (utils/pipeline.py::BatchPipeline, shuffle_seed) against the JAX
package's on the CPU.

The augmentation is data movement: on JAX's draws (its key chain replayed,
``_torch_train_helpers.aug_draws``, fed through ``augment.draw_augment``)
crop, flip and cutout equal JAX's bit for bit.  The pipeline decodes with
PIL in both packages: its batches, their order, the tail refill and the
decode-failure refill are bit-equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _torch_train_helpers as H
from image_recognition_adversarial_example_attack_tpu.train import augment as jax_aug
from image_recognition_adversarial_example_attack_tpu.utils import pipeline as jax_pipeline
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.train import augment
from image_recognition_adversarial_example_attack_tpu_torch.utils import pipeline

POLICIES = [dict(pad=4), dict(flip=True), dict(cutout=8), dict(pad=4, flip=True),
            dict(pad=2, flip=True, cutout=5), dict(cutout=1)]


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(0).rand(6, 12, 10, 3).astype(np.float32)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: "+".join(f"{k}{v}" for k, v in
                                                                    p.items()))
def test_augment_equals_jaxs_on_its_draws(policy, batch, monkeypatch):
    key = jax.random.PRNGKey(sum(policy.values()) + 3)
    want = np.asarray(jax_aug.make_augment_fn(jax_aug.AugmentConfig(**policy))(
        key, jnp.asarray(batch)))
    draws = H.aug_draws(key, batch.shape, policy.get("pad", 0))
    monkeypatch.setattr(augment, "draw_augment", lambda *a: draws)
    got = augment.make_augment_fn(augment.AugmentConfig(**policy))(
        generator_from_seed(0), torch.from_numpy(batch)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, batch)


def test_each_transform_equals_jaxs(batch):
    key = jax.random.PRNGKey(7)
    offsets, coins, cy, cx = H.aug_draws(key, batch.shape, 3)
    k_crop, k_flip, k_cut = jax.random.split(key, 3)
    x = jnp.asarray(batch)
    t = torch.from_numpy(batch)
    assert np.array_equal(augment.random_crop(t, 3, offsets).numpy(),
                          np.asarray(jax_aug.random_crop(k_crop, x, 3)))
    assert np.array_equal(augment.random_flip(t, coins).numpy(),
                          np.asarray(jax_aug.random_flip(k_flip, x)))
    assert np.array_equal(augment.random_cutout(t, 4, cy, cx).numpy(),
                          np.asarray(jax_aug.random_cutout(k_cut, x, 4)))


def test_empty_policy_draws_nothing_and_draws_are_in_range(batch):
    assert augment.make_augment_fn(augment.AugmentConfig()) is None
    assert jax_aug.make_augment_fn(jax_aug.AugmentConfig()) is None
    assert not augment.AugmentConfig().enabled and augment.AugmentConfig(cutout=2).enabled
    draws = [augment.draw_augment((500, 12, 10, 3), 4, generator_from_seed(1), "cpu")
             for _ in range(2)]
    offsets, coins, cy, cx = draws[0]
    assert offsets.shape == (500, 2) and coins.shape == cy.shape == cx.shape == (500,)
    assert int(offsets.min()) == 0 and int(offsets.max()) == 8 and coins.dtype == torch.bool
    assert 0 < float(coins.float().mean()) < 1
    assert int(cy.max()) == 11 and int(cx.max()) == 9 and int(cy.min()) == int(cx.min()) == 0
    assert all(torch.equal(a, b) for a, b in zip(draws[0], draws[1]))  # same seed, same draws


@pytest.mark.parametrize("seed,epoch", [(0, 0), (17, 3), (2**40, 9), (-1, 2)])
def test_shuffle_seed_equals_jaxs(seed, epoch):
    assert pipeline.shuffle_seed(seed, epoch) == jax_pipeline.shuffle_seed(seed, epoch)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Seven PNGs (one of them not an image) and their labels."""
    d = tmp_path_factory.mktemp("train_ds")
    rs = np.random.RandomState(4)
    paths, labels = [], []
    for i in range(7):
        p = d / f"img_{i}.png"
        Image.fromarray((rs.rand(20, 24, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
        labels.append(i % 3)
    (d / "img_5.png").write_bytes(b"not an image")
    return paths, labels


def _batches(mod, paths, labels, **kw):
    return list(mod.BatchPipeline(paths, labels, 3, size=16, **kw))


@pytest.mark.parametrize("kw", [dict(epochs=2), dict(epochs=3, start_epoch=1, seed=5),
                                dict(epochs=1, seed=9, prefetch=1)],
                         ids=["two_epochs", "start_epoch", "prefetch1"])
def test_batch_pipeline_equals_jaxs(kw, dataset):
    """(epoch, step, x, y) bit-equal to JAX's pipeline: the epoch order, the
    tail refill from the epoch's order and the refill of the unreadable
    image's row by repeating decoded rows."""
    paths, labels = dataset
    ours = _batches(pipeline, paths, labels, **kw)
    theirs = _batches(jax_pipeline, paths, labels, **kw)
    assert [(e, s) for e, s, _, _ in ours] == [(e, s) for e, s, _, _ in theirs]
    start = kw.get("start_epoch", 0)
    assert [e for e, _, _, _ in ours] == [e for e in range(start, kw["epochs"]) for _ in range(2)]
    refilled = 0
    for (_, _, x, y), (_, _, xj, yj) in zip(ours, theirs):
        assert x.dtype == xj.dtype == np.float32 and y.dtype == yj.dtype == np.int32
        assert x.shape == (3, 16, 16, 3) and np.array_equal(x, xj) and np.array_equal(y, yj)
        refilled += len({r.tobytes() for r in x}) < 3
    assert refilled >= 1  # the unreadable image's batches repeat a decoded row


def test_batch_pipeline_surfaces_errors_as_jaxs(tmp_path, dataset):
    paths, labels = dataset
    for mod in (pipeline, jax_pipeline):
        with pytest.raises(ValueError, match="paths vs"):
            mod.BatchPipeline(paths, labels[:3], 2)
        with pytest.raises(ValueError, match="empty dataset"):
            mod.BatchPipeline([], [], 2)
    bad = [tmp_path / f"bad_{i}.png" for i in range(2)]
    for p in bad:
        p.write_bytes(b"x")
    errors = []
    for mod in (pipeline, jax_pipeline):
        with pytest.raises(ValueError) as e:
            list(mod.BatchPipeline(bad, [0, 1], 2, size=16))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "no readable images in batch"
    pipe = pipeline.BatchPipeline(paths, labels, 3, size=16)
    assert pipe.steps_per_epoch == 2
    list(pipe)
    with pytest.raises(RuntimeError, match="single-use"):
        list(pipe)
