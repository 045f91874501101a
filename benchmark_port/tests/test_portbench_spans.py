"""The readers of the program's span log (``spanlog.py``, ``metrics/``), each
on a hand-made log whose value is worked out by hand, and their None where
the log is missing, has no device intervals or belongs to the other kind of
cell."""

from __future__ import annotations

import pytest

from conftest import BENCH, load_harness

harness = load_harness(BENCH)
spanlog = harness.load("spanlog")
MS = 1_000_000  # ns


def span(i, name, parent, dev=None, host=(0, 0), syncs=None):
    return {"name": name, "id": i, "parent": parent, "top": None,
            "host_enter_ns": host[0], "host_exit_ns": host[1],
            "device_enter_ns": None if dev is None else dev[0],
            "device_exit_ns": None if dev is None else dev[1],
            "counts": {} if syncs is None else {"syncs": {"n": syncs[0], "blocked_s": syncs[1]}}}


# one PGD step: leaves noise [10,90], normalize [100,150], net [200,500],
# backward [500,900], pgd_step [950,990] in an attack of [0,1000]: gaps of
# 10+10+50+0+50+10 = 130 (13%); passes 3 ms + 1 ms less 1 ms blocked, over 2
EVAL = [
    span(1, "attack", None, (0, 1000)),
    span(2, "attack.start", 1, (0, 100)),
    span(3, "kernel.noise", 2, (10, 90)),
    span(4, "attack.step", 1, (100, 1000)),
    span(5, "model.forward", 4, (100, 500), host=(0, 3 * MS)),
    span(6, "model.normalize", 5, (100, 150), syncs=(2, 0.001)),
    span(7, "model.net", 5, (200, 500)),
    span(8, "model.backward", 4, (500, 900), host=(3 * MS, 4 * MS)),
    span(9, "kernel.pgd_step", 4, (950, 990)),
    # the prediction lies outside the attack: none of it counts
    span(10, "predict", None, (1000, 3000)),
    span(11, "model.forward", 10, (1000, 3000), host=(4 * MS, 50 * MS), syncs=(7, 0.0)),
]

# one training step of [0,2000]: gaps 250-300, 1050-1100, 1700-1800 = 200
# (10%); 4 syncs; passes 2+1+1+2 ms less 1 ms blocked, over 4
TRAIN = [
    span(20, "train.step", None, (0, 2000)),
    span(21, "train.cast", 20, (0, 200)),
    span(22, "attack", 20, (200, 1000)),
    span(23, "attack.step", 22, (200, 1000)),
    span(24, "model.forward", 23, (200, 600), host=(1 * MS, 3 * MS)),
    span(25, "model.normalize", 24, (200, 250), syncs=(2, 0.0005)),
    span(26, "model.net", 24, (300, 600)),
    span(27, "model.backward", 23, (600, 900), host=(3 * MS, 4 * MS)),
    span(28, "kernel.pgd_step", 23, (900, 1000)),
    span(29, "train.forward_backward", 20, (1000, 1800)),
    span(30, "model.forward", 29, (1000, 1300), host=(5 * MS, 6 * MS)),
    span(31, "model.normalize", 30, (1000, 1050), syncs=(2, 0.0005)),
    span(32, "model.net", 30, (1100, 1300)),
    span(33, "model.backward", 29, (1300, 1700), host=(6 * MS, 8 * MS)),
    span(34, "train.optimizer", 20, (1800, 2000)),
]

# two batches: defend 0.5 and 0.7 ms, detector 0.3 + 0.2 and 0.1 + 0.3 ms;
# the defense inside an (adaptive) attack is no stage of its own
DEFENSE = [
    span(40, "defense.eval", None, (0, 5 * MS)),
    span(41, "defense.defend", 40, (1 * MS, int(1.5 * MS))),
    span(42, "kernel.quantize", 41, (int(1.2 * MS), int(1.3 * MS))),
    span(43, "detector.score", 40, (2 * MS, int(2.3 * MS))),
    span(44, "detector.score", 40, (int(2.4 * MS), int(2.6 * MS))),
    span(45, "attack", 40, (int(0.1 * MS), int(0.9 * MS))),
    span(46, "defense.defend", 45, (int(0.1 * MS), int(0.5 * MS))),
    span(50, "defense.eval", None, (5 * MS, 10 * MS)),
    span(51, "defense.defend", 50, (6 * MS, int(6.7 * MS))),
    span(52, "detector.score", 50, (7 * MS, int(7.1 * MS))),
    span(53, "detector.score", 50, (int(7.2 * MS), int(7.5 * MS))),
]

CASES = [
    ("syncs_per_step.eval", "eval", EVAL, 2.0),
    ("issue_ms_per_pass.eval", "eval", EVAL, 1.5),
    ("starved_share.eval", "eval", EVAL, 13.0),
    ("syncs_per_step.train", "train", TRAIN, 4.0),
    ("issue_ms_per_pass.train", "train", TRAIN, 1.25),
    ("starved_share.train", "train", TRAIN, 10.0),
    ("defend_ms.eval", "eval", DEFENSE, 0.6),
    ("detector_ms.eval", "eval", DEFENSE, 0.45),
]


def on_cpu(spans):
    """The same log as a CPU run gives it: no device intervals."""
    return [dict(s, device_enter_ns=None, device_exit_ns=None) for s in spans]


@pytest.mark.parametrize("metric,kind,spans,value", CASES, ids=[c[0] for c in CASES])
def test_reader_on_a_hand_made_log(metric, kind, spans, value):
    reader = harness.load(f"metrics/{metric}")
    assert reader.read({"kind": kind}, spans) == pytest.approx(value)
    other = "train" if kind == "eval" else "eval"
    assert reader.read({"kind": other}, spans) is None
    host_only = metric.startswith(("syncs_per_step", "issue_ms_per_pass"))
    got = reader.read({"kind": kind}, on_cpu(spans))
    assert got == pytest.approx(value) if host_only else got is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_reader_without_the_programs_log_reads_nothing(metric, monkeypatch):
    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    reader = harness.load(f"metrics/{metric}")
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert spanlog.records() is None
    assert reader.read({"kind": "eval"}) is None and reader.read({"kind": "train"}) is None
