"""The reader of the window attention's route counters,
``window_attn_fused_share.eval``, on hand-made span logs."""

from __future__ import annotations

import pytest

from conftest import BENCH, load_harness

harness = load_harness(BENCH)


def span(i, name, parent, counts=None):
    return {"name": name, "id": i, "parent": parent, "top": None, "host_enter_ns": 0,
            "host_exit_ns": 1, "device_enter_ns": None, "device_exit_ns": None,
            "counts": {k: {"n": n, "blocked_s": 0.0} for k, n in (counts or {}).items()}}


def forward(net_id, routes):
    """One model.net span and a swin.attn span a block, each counting its
    shift and its route."""
    out = [span(net_id, "model.net", None)]
    for i, (shifted, route) in enumerate(routes, 1):
        key = "window_attn.shifted" if shifted else "window_attn.plain"
        out.append(span(net_id + i, "swin.attn", net_id, {key: 1, f"window_attn.{route}": 1}))
    return out


def test_fused_share_reads_100_on_a_fused_log_and_none_without_the_counters():
    reader = harness.load("metrics/window_attn_fused_share.eval")
    fused = forward(10, [(False, "fused"), (True, "fused")]) + forward(20, [(True, "fused")])
    assert reader.read({"kind": "eval"}, fused) == pytest.approx(100.0)
    mixed = fused + forward(30, [(False, "written")])
    assert reader.read({"kind": "eval"}, mixed) == pytest.approx(75.0)
    assert reader.read({"kind": "train"}, fused) is None
    # the parent's program counts the shift alone: neither route counter
    parent = [dict(s, counts={k: v for k, v in s["counts"].items()
                              if k in ("window_attn.shifted", "window_attn.plain")})
              for s in fused]
    assert reader.read({"kind": "eval"}, parent) is None
    assert reader.read({"kind": "eval"}, []) is None


def test_reader_without_the_programs_log_reads_nothing(monkeypatch):
    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    reader = harness.load("metrics/window_attn_fused_share.eval")
    monkeypatch.delattr(profiling, "spans")
    assert reader.read({"kind": "eval"}) is None


def test_the_reader_on_a_cpu_forward_of_the_program():
    """The program's own counters, read from its span log: on the CPU every
    window attention of ``swin_tiny_test`` (4 blocks) is written out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_recognition_adversarial_example_attack_tpu_torch.models import swin
    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    model = swin.swin_tiny_test().eval()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(torch.rand((1, 3, 32, 32)))
    spans = profiling.spans()
    profiling.reset_spans()
    reader = harness.load("metrics/window_attn_fused_share.eval")
    assert sum(s["counts"].get("window_attn.written", {"n": 0})["n"] for s in spans) == 4
    assert reader.read({"kind": "eval"}, spans) == 0.0
