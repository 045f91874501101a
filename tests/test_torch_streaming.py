"""The port's streaming data plane (utils/pipeline.py, eval/streaming.py,
core/rng.py::chunk_generator) against the JAX package's on the CPU.

The chunks are decoded by the same PIL code on both sides, so the pipelines
must agree bit for bit.  The streamed cells run resnet_tiny on bridged
float64 weights: fgsm and cw are deterministic, so their counters must equal
the JAX package's streamed counters and the port's one-batch counters."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.eval import defense_eval as jax_eval
from image_recognition_adversarial_example_attack_tpu.eval import streaming as jax_streaming
from image_recognition_adversarial_example_attack_tpu.utils import pipeline as jax_pipeline
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.core.images import (
    load_image_batch_tolerant)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
    feature_score, make_features_fn)
from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
    DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch)
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
    make_placer, round_up, stream_defense_cell)
from image_recognition_adversarial_example_attack_tpu_torch.utils.pipeline import (
    EvalBatchPipeline)

SIZE, EPS = 32, 8 / 255


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    rs = np.random.RandomState(7)
    paths = []
    for i in range(10):
        p = d / f"img_{i:02d}.png"
        Image.fromarray((rs.rand(40, 36, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    bad = d / "corrupt.jpg"
    bad.write_bytes(b"not an image")
    return {"paths": paths, "bad": bad}


def _drain(pipe):
    return [(s, x, None if y is None else y.tolist(), nv) for s, x, y, nv in pipe]


@pytest.mark.parametrize("case", ["ordered", "tail", "unreadable", "unreadable_chunk",
                                  "no_labels"])
def test_pipeline_matches_jax(images, case):
    """Same steps, n_valid, decoded and padded rows, and labels, chunk for
    chunk, as the JAX package's EvalBatchPipeline."""
    paths, bad = list(images["paths"]), images["bad"]
    chunk = 5
    if case == "tail":
        chunk = 4
    elif case == "unreadable":
        paths = paths[:3] + [bad] + paths[3:]
        chunk = 4
    elif case == "unreadable_chunk":
        paths = [bad, bad] + paths[:5]
        chunk = 2
    labels = None if case == "no_labels" else list(range(100, 100 + len(paths)))
    ours = _drain(EvalBatchPipeline(paths, chunk, labels=labels, size=SIZE))
    theirs = _drain(jax_pipeline.EvalBatchPipeline(paths, chunk, labels=labels, size=SIZE))
    assert [(s, y, nv) for s, _, y, nv in ours] == [(s, y, nv) for s, _, y, nv in theirs]
    for (_, xa, _, _), (_, xb, _, _) in zip(ours, theirs):
        assert xa.shape == (chunk, SIZE, SIZE, 3)
        np.testing.assert_array_equal(xa, xb)
    # every readable image once, in order
    flat = np.concatenate([x[:nv] for _, x, _, nv in ours])
    readable = [p for p in paths if p != bad]
    np.testing.assert_array_equal(flat, load_image_batch_tolerant(readable, size=SIZE)[0])
    if case == "unreadable_chunk":
        assert [s for s, *_ in ours] == [0, 1, 2] and ours[-1][3] == 1


def test_pipeline_reaps_an_abandoned_iteration_and_is_single_use(images):
    pipe = EvalBatchPipeline(images["paths"], 1, size=SIZE, prefetch=1)
    it = iter(pipe)
    next(it)
    assert pipe._thread.is_alive()  # blocked on the full queue
    it.close()
    assert not pipe._thread.is_alive()
    assert all(t is not pipe._thread for t in threading.enumerate())
    with pytest.raises(RuntimeError, match="single-use"):
        next(iter(pipe))
    with pytest.raises(ValueError, match="empty dataset"):
        EvalBatchPipeline([], 4)
    with pytest.raises(ValueError, match="10 paths vs 2 labels"):
        EvalBatchPipeline(images["paths"], 4, labels=[1, 2])


def test_round_up():
    assert [round_up(10, 4), round_up(8, 4), round_up(1, 1), round_up(5, 0)] == [12, 8, 1, 5]


@pytest.fixture(scope="module")
def models():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=9)
        lf_jax = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        ff_jax = jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    lf = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)
    ff = make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)
    return {"jax": (lf_jax, ff_jax), "port": (lf, ff)}


def _place64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float64))


def _pseudo(lf):
    return lambda xx: torch.argmax(lf(xx), dim=-1)


@pytest.fixture(scope="module")
def resident(images, models):
    """The whole set as one float64 batch, its pseudo-labels and a
    threshold at the median clean feature score (so flags vary)."""
    x = _place64(load_image_batch_tolerant(images["paths"], size=SIZE)[0])
    lf, ff = models["port"]
    with torch.no_grad():
        y = _pseudo(lf)(x)
        thr = float(torch.median(feature_score(ff, x)))
    return {"x": x, "y": y, "thr": thr}


CELL = dict(eps=0.0, alpha=2 / 255, steps=2, cw_steps=3, cw_c=5.0)  # eps is set per call


def _cfg(attack):
    return DefenseEvalConfig(attack_name=attack, **CELL)


@pytest.mark.parametrize("labelled", [False, True])
@pytest.mark.parametrize("attack", ["fgsm", "cw"])
def test_deterministic_cells_match_jax_and_the_one_batch_path(images, models, resident,
                                                              attack, labelled):
    """fgsm and cw streamed in chunks of 4 (the last with n_valid 2): the
    six counters equal the JAX package's streamed cell and the port's
    one-batch cell.  ``labelled``: ground truth with the -1 sentinel on
    every third image, resolved to the pseudo-label per chunk."""
    paths, thr = images["paths"], resident["thr"]
    lf, ff = models["port"]
    labels = None
    y_one = resident["y"]
    if labelled:
        labels = np.asarray((resident["y"].numpy() + np.arange(10)) % 10)
        labels[::3] = -1
        y_one = torch.where(torch.from_numpy(labels) < 0, resident["y"], torch.from_numpy(labels))
    ours = stream_defense_cell(lf, ff, _cfg(attack), paths, thr, seed=0, cell_id=attack,
                               eps=EPS, chunk_size=4, place=_place64, size=SIZE,
                               pseudo_label_fn=_pseudo(lf), labels=labels)
    one = aggregate_stats(evaluate_defenses_batch(lf, ff, resident["x"], y_one, thr,
                                                  _cfg(attack), eps_override=EPS))
    with jax.enable_x64():
        lf_jax, ff_jax = models["jax"]
        fn = jax_eval.make_defense_eval_fn_dynamic_eps(lf_jax, ff_jax, jax_eval.DefenseEvalConfig(attack_name=attack, **CELL))
        theirs = jax_streaming.stream_defense_cell(
            fn, paths, thr, jax.random.PRNGKey(0), jnp.float64(EPS), chunk_size=4, size=SIZE,
            pseudo_label_fn=jax.jit(lambda xx: jnp.argmax(lf_jax(xx), -1)), labels=labels,
            place=lambda a: jnp.asarray(a, jnp.float64))
    assert ours == theirs == one
    assert ours["count"] == 10
    assert 0 < ours["detector_flags_clean"] < 10  # the threshold splits the set


def test_pgd_cell_chunks_draw_reproducibly(images, models, resident):
    """pgd's random start per chunk: counters in range, the same on a
    second run, and each chunk's generator a function of (seed, cell, step)."""
    lf, ff = models["port"]
    run = [stream_defense_cell(lf, ff, _cfg("pgd"), images["paths"], resident["thr"], seed=3,
                               cell_id="pgd:0.031373", eps=EPS, chunk_size=4, place=_place64,
                               size=SIZE, pseudo_label_fn=_pseudo(lf))
           for _ in range(2)]
    assert run[0] == run[1] and run[0]["count"] == 10
    assert all(0 <= v <= 10 for v in run[0].values())

    def draw(*key):
        return torch.rand(5, generator=chunk_generator(*key))

    assert torch.equal(draw(3, "pgd:0.031373", 1), draw(3, "pgd:0.031373", 1))
    others = [draw(3, "pgd:0.031373", 2), draw(4, "pgd:0.031373", 1), draw(3, "pgd:0.062745", 1)]
    assert not any(torch.equal(draw(3, "pgd:0.031373", 1), o) for o in others)


def test_clean_cache_guards_its_chunking(images, models, resident):
    lf, ff = models["port"]
    cache: dict = {}
    kw = dict(seed=0, cell_id="fgsm", eps=EPS, place=_place64, size=SIZE,
              pseudo_label_fn=_pseudo(lf), clean_cache=cache)
    first = stream_defense_cell(lf, ff, _cfg("fgsm"), images["paths"], resident["thr"],
                                chunk_size=4, **kw)
    assert sorted(k for k in cache if k != "__sig__") == [0, 1, 2]
    # the cached pseudo-labels serve a second cell of the same chunking
    assert stream_defense_cell(lf, ff, _cfg("fgsm"), images["paths"], resident["thr"],
                               chunk_size=4, **kw) == first
    with pytest.raises(ValueError, match="pass a fresh dict"):
        stream_defense_cell(lf, ff, _cfg("fgsm"), images["paths"], resident["thr"],
                            chunk_size=5, **kw)
    with pytest.raises(ValueError, match="UNLABELED"):
        stream_defense_cell(lf, ff, _cfg("fgsm"), images["paths"], resident["thr"],
                            chunk_size=4, seed=0, cell_id="fgsm", eps=EPS, place=_place64,
                            size=SIZE, labels=[-1] * 10)


@pytest.mark.parametrize("env,uint8", [(None, False), ("off", False), ("1", True),
                                       ("true", True)])
def test_placer_against_jax_and_the_host(env, uint8, monkeypatch):
    """The same opt-in toggle as the JAX placer.  The float path is the
    chunk itself.  The uint8 path is bit-equal to the host's
    ``round(x*255) / float32(255)``, a true division, so a decoded image
    (whose pixels are such quotients) crosses it unchanged.  XLA rewrites
    JAX's ``/ 255.0`` as a product with the rounded reciprocal, so the JAX
    placer differs from it by at most one ulp on some pixels."""
    if env is None:
        monkeypatch.delenv("ADV_TPU_TRANSFER_UINT8", raising=False)
    else:
        monkeypatch.setenv("ADV_TPU_TRANSFER_UINT8", env)
    x = np.random.RandomState(3).uniform(-0.01, 1.01, (4, 8, 8, 3)).astype(np.float32)
    x[0, 0, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255]  # ties of the rounding
    got = make_placer("cpu")(x)
    theirs = np.asarray(jax_streaming.make_placer()(x))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    u8 = np.round(x * 255).clip(0, 255).astype(np.uint8)
    if not uint8:
        np.testing.assert_array_equal(got.numpy(), x)
        np.testing.assert_array_equal(theirs, x)
        return
    np.testing.assert_array_equal(got.numpy(), u8.astype(np.float32) / np.float32(255))
    np.testing.assert_array_equal(theirs, u8.astype(np.float32) * np.float32(1 / 255))
    np.testing.assert_array_max_ulp(got.numpy(), theirs, maxulp=1)
    decoded = u8.astype(np.float32) / 255.0  # core/images.py's scaling
    np.testing.assert_array_equal(make_placer("cpu")(decoded).numpy(), decoded)
