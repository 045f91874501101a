"""The port's query-efficiency curves (eval/query_curves.py) and
``stream_query_curve_hist`` against the JAX package's on the CPU: the budget
arithmetic and the curve assembly equal to JAX's, ``query_curve`` of every
curve attack on float64 resnet_tiny with JAX's draws fed in (the same
curve), and the streamed statistics equal to one resident run a chunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_blackbox_helpers import (bandits_draws, constant, feed, make_setup, probe_draws,
                                     simba_draws, square_draws, square_l2_draws, t)
from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.eval import query_curves as jax_qc
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    bandits, grad_est, make_logits_fn, predict_labels, simba, square)
from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
    chunk_generator, generator_from_seed)
from image_recognition_adversarial_example_attack_tpu_torch.eval import query_curves as qc
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
    make_placer, stream_query_curve_hist)
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

EST = 2  # nes/spsa probe pairs a step: 4 queries
# attack -> query budget: 20 square steps, 10 simba steps, 3 nes/spsa steps,
# 6 bandits steps
BUDGETS = {"square": 22, "square_l2": 22, "simba": 21, "nes": 12, "spsa": 13, "bandits": 12}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def test_curve_attacks_are_jaxs():
    assert qc.CURVE_ATTACKS == jax_qc.CURVE_ATTACKS


@pytest.mark.parametrize("attack", sorted(BUDGETS))
def test_budget_to_steps_equals_jaxs(attack):
    for budget in (0, 1, 2, 3, 64, 65, 500, 2000):
        for est in (1, 2, 32):
            assert qc.budget_to_steps(attack, budget, est) == jax_qc.budget_to_steps(
                attack, budget, est)


def test_assemble_curve_and_checkpoints_equal_jaxs():
    rs = np.random.RandomState(0)
    for steps, n in ((1, 3), (9, 5), (40, 17)):
        hist = rs.rand(steps, n) < 0.15
        ever_count, first = qc.history_stats(hist)
        ever = np.maximum.accumulate(hist, axis=0)
        np.testing.assert_array_equal(ever_count, ever.sum(axis=1))
        np.testing.assert_array_equal(
            first, np.where(ever.any(axis=0), ever.argmax(axis=0), -1))
        for per_step, init_q in ((1, 2), (2, 1), (64, 0)):
            got = qc.assemble_curve("x", ever_count, n, first, per_step=per_step,
                                    init_q=init_q, steps=steps)
            want = jax_qc.assemble_curve("x", ever_count, n, first, per_step=per_step,
                                         init_q=init_q, steps=steps)
            assert got == want
            cps = [0, 1, init_q + per_step, 7, 10**6]
            assert qc.curve_at_checkpoints(got, cps) == jax_qc.curve_at_checkpoints(want, cps)
    none = qc.assemble_curve("x", np.zeros(3, np.int64), 4, np.full(4, -1), per_step=1,
                             init_q=0, steps=3)
    assert none["median_queries_to_success"] is None and none["final_asr"] == 0.0


def _feed(monkeypatch, attack: str, key, steps: int, shape):
    if attack == "square":
        monkeypatch.setattr(square, "draw_square", constant(square_draws(key, steps, shape)))
    elif attack == "square_l2":
        monkeypatch.setattr(square, "draw_square_l2",
                            constant(square_l2_draws(key, steps, shape)))
    elif attack == "simba":
        monkeypatch.setattr(simba, "draw_simba",
                            constant(simba_draws(key, steps, shape[0], 4, 4, 3)))
    elif attack in ("nes", "spsa"):
        sampler = "gaussian" if attack == "nes" else "rademacher"
        monkeypatch.setattr(grad_est, "draw_probe",
                            feed(probe_draws(key, steps, EST, shape, sampler)))
    else:
        monkeypatch.setattr(bandits, "draw_latent",
                            feed(bandits_draws(key, steps, (shape[0], 4, 4, 3))))


@pytest.mark.parametrize("attack", sorted(BUDGETS))
def test_query_curve_equals_jaxs(setup, attack, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key, budget = jax.random.PRNGKey(21), BUDGETS[attack]
    steps = qc.budget_to_steps(attack, budget, EST)
    _feed(monkeypatch, attack, key, steps, x.shape)
    kw = dict(eps=8 / 255, max_queries=budget, est_samples=EST, nes_sigma=1e-2,
              spsa_delta=5e-2)
    with jax.enable_x64():
        want = jax_qc.query_curve(attack, lf_jax, jnp.asarray(x), jnp.asarray(y), key=key, **kw)
    got = qc.query_curve(attack, lf_port, t(x), t(y), generator=generator_from_seed(0), **kw)
    assert got == want
    assert len(got["queries"]) == steps


def test_stream_query_curve_hist_equals_per_chunk_runs(tmp_path):
    """Four PNGs in chunks of two, square at 12 queries: the two reductions
    are the sums (and the concatenation) of the resident runs', each chunk
    under its generator; one clean forward a chunk serves both attacks."""
    rs = np.random.RandomState(5)
    paths = []
    for i in range(4):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray((rs.rand(32, 32, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    b = zoo.load_model("resnet_tiny", device="cpu")
    lf = make_logits_fn(b.model, b.mean, b.std)
    calls = []

    def pseudo(xx):
        calls.append(1)
        return predict_labels(lf, xx)

    cache: dict = {}
    for attack in ("square", "simba"):
        steps = qc.budget_to_steps(attack, 12)
        fn, _, _ = qc._runner(attack, lf, eps=8 / 255, steps=steps, est_samples=32,
                              nes_sigma=1e-3, spsa_delta=1e-2, alpha=2 / 255, simba_eps=0.2,
                              simba_mode="dct")
        got = stream_query_curve_hist(fn, steps, paths, seed=3, cell_id=attack, chunk_size=2,
                                      place=make_placer("cpu"), size=32,
                                      pseudo_label_fn=pseudo, clean_cache=cache)
        want_count, want_first = np.zeros(steps, np.int64), []
        for step in range(2):
            x = torch.from_numpy(load_image_batch(paths[2 * step:2 * step + 2], size=32))
            _, hist = fn(x, predict_labels(lf, x), chunk_generator(3, attack, step))
            count, first = qc.history_stats(hist.numpy())
            want_count += count
            want_first.append(first)
        np.testing.assert_array_equal(got["ever_count"], want_count)
        np.testing.assert_array_equal(got["first"], np.concatenate(want_first))
        assert got["count"] == 4
    assert len(calls) == 2  # one clean forward a chunk, for both attacks
