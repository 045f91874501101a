"""The port's span-and-counter recorder (``utils/profiling.py``) and the spans
its layers open: off outside a profiler session, nested ids under one, the
counter on the innermost span, the trees of a PGD-2 attack with its
prediction, of a defense cell and of a PGD-AT step on the tiny model, the
phase timer's JSON, and the log that ``maybe_profile`` writes.  CPU only:
the device intervals need a card (the benchmark's traced runs read them).
"""

import json

import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import (
    AttackParams, make_logits_fn, predict_labels, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.cli.common import maybe_profile
from image_recognition_adversarial_example_attack_tpu_torch.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.models.tiny import make_tiny
from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import ModelBundle
from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

MODEL_SPANS = ("model.forward", (("model.normalize", ()), ("model.net", ())))
PGD_STEP = ("attack.step", (MODEL_SPANS, ("model.backward", ()), ("kernel.pgd_step", ())))


def recorded(fn):
    """``fn()``'s spans under a CPU profiler session, from an empty log."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    records = profiling.spans()
    profiling.reset_spans()
    return records


def trees(records):
    """The records as (name, children) trees, one per top-level span."""
    kids = {}
    for r in records:
        kids.setdefault(r["parent"], []).append(r)

    def tree(r):
        return (r["name"], tuple(tree(c) for c in kids.get(r["id"], [])))

    return [tree(r) for r in kids.get(None, [])]


def tiny_batch():
    model, _ = make_tiny(seed=0)
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    return model, x, torch.tensor([1, 3])


def test_span_without_a_profiler_records_nothing_and_is_the_shared_noop():
    profiling.reset_spans()
    assert profiling.span("a") is profiling.span("b") is profiling._NOOP
    assert profiling.count("syncs") is profiling._NOOP
    with profiling.span("a"), profiling.count("syncs"):
        pass
    assert profiling.spans() == [] and profiling.origins_ns() == {}


def test_nested_spans_get_parent_and_top_ids_and_counts_land_on_the_innermost():
    def work():
        with profiling.span("outer"):
            with profiling.span("mid"):
                with profiling.span("leaf"), profiling.count("syncs"):
                    pass
                with profiling.count("syncs"), profiling.count("syncs"):
                    pass
            with profiling.span("second"), profiling.count("syncs", on=False):
                pass
        with profiling.span("next"):
            pass

    r = {rec["name"]: rec for rec in recorded(work)}
    assert [rec for rec in r] == ["outer", "mid", "leaf", "second", "next"]
    outer = r["outer"]["id"]
    assert r["outer"]["parent"] is None and r["outer"]["top"] == outer
    assert r["mid"]["parent"] == outer and r["leaf"]["parent"] == r["mid"]["id"]
    assert r["second"]["parent"] == outer
    assert {r[n]["top"] for n in ("mid", "leaf", "second")} == {outer}
    assert r["next"]["parent"] is None and r["next"]["top"] == r["next"]["id"]
    assert r["leaf"]["counts"]["syncs"]["n"] == 1
    assert r["mid"]["counts"]["syncs"]["n"] == 2
    assert r["outer"]["counts"] == r["second"]["counts"] == {}
    for rec in r.values():
        assert rec["host_enter_ns"] <= rec["host_exit_ns"]
        assert rec["device_enter_ns"] is None and rec["device_exit_ns"] is None
    assert r["mid"]["counts"]["syncs"]["blocked_s"] >= 0.0


def test_pgd2_attack_and_prediction_give_the_layer_tree():
    model, x, y = tiny_batch()
    logits_fn = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)

    def work():
        x_adv = run_attack("pgd", logits_fn, x, y, AttackParams(steps=2), generator_from_seed(0))
        predict_labels(logits_fn, x_adv)

    assert trees(recorded(work)) == [
        ("attack", (("attack.start", (("kernel.noise", ()),)), PGD_STEP, PGD_STEP)),
        ("predict", (MODEL_SPANS,)),
    ]


def test_defense_cell_gives_the_defense_and_detector_spans():
    from image_recognition_adversarial_example_attack_tpu_torch.defenses.detector import (
        make_features_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, evaluate_defenses_batch)

    model, x, y = tiny_batch()
    logits_fn = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)
    features_fn = make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)
    config = DefenseEvalConfig(attack_name="pgd", eps=8 / 255, alpha=2 / 255, steps=1)
    (cell,) = trees(recorded(lambda: evaluate_defenses_batch(
        logits_fn, features_fn, x, y, 1.0, config, generator_from_seed(0))))
    predicted = ("predict", (MODEL_SPANS,))
    assert cell == ("defense.eval", (
        ("defense.clean_predict", (predicted,)),
        ("attack", (("attack.start", (("kernel.noise", ()),)), PGD_STEP)),
        ("defense.adv_predict", (predicted,)),
        ("defense.defend", (("kernel.quantize", ()),)),
        ("defense.defended_predict", (predicted,)),
        ("detector.score", (MODEL_SPANS,)),
        ("detector.score", (MODEL_SPANS,)),
    ))


def test_pgd_at_step_gives_the_training_tree():
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    model, x, y = tiny_batch()
    bundle = ModelBundle(name="tiny", model=model, source="random", dtype=torch.float32,
                         device=torch.device("cpu"))
    config = AdvTrainConfig(eps=8 / 255, alpha=2 / 255, attack_steps=2, learning_rate=1e-3)
    state = train_state_from_bundle(bundle, config)
    step = make_train_step(config, bundle.mean, bundle.std)
    (tree,) = trees(recorded(lambda: step(state, x, y, generator_from_seed(0))))
    assert tree == ("train.step", (
        ("train.cast", ()),
        ("attack", (("attack.start", (("kernel.noise", ()),)), PGD_STEP, PGD_STEP)),
        ("train.forward_backward", (MODEL_SPANS, ("model.backward", ()))),
        ("train.optimizer", ()),
    ))


def test_phase_timer_json_is_unchanged_and_each_phase_is_a_span():
    timer = profiling.PhaseTimer()

    def work():
        with timer.phase("cell", examples=4):
            pass
        with timer.phase("other"):
            pass

    assert [r["name"] for r in recorded(work)] == ["cell", "other"]
    out = timer.as_dict()
    assert list(out) == ["cell", "other"]
    assert list(out["cell"]) == ["seconds", "examples", "examples_per_sec"]
    assert out["cell"]["examples"] == 4 and list(out["other"]) == ["seconds"]
    assert out["cell"]["seconds"] == round(timer.records[0].seconds, 4)


def test_maybe_profile_writes_the_log_beside_its_trace(tmp_path):
    with maybe_profile(str(tmp_path)):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    log = json.loads((tmp_path / "spans.json").read_text())
    assert (tmp_path / "trace.json").is_file()
    assert log["origins_ns"] == {}
    assert [(r["name"], r["parent"]) for r in log["spans"]] == [
        ("a", None), ("b", log["spans"][0]["id"])]
