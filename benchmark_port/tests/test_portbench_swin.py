"""The Swin-L configuration's pieces: its three readers on hand-made span
logs, its configuration against the reference's parameter spec and the FLOP
count, and a Swin cell at ``swin_tiny_test``'s shapes through the harness on
the CPU, with the reference's check and the readers of a traced run."""

from __future__ import annotations

import json
import math
import shutil
import time

import pytest

from conftest import ATTACK_LIMITS, BENCH, REPO, TRAFFIC, load_harness

harness = load_harness(BENCH)
CELL = "swin_l.pgd10.b128"
MS = 1_000_000  # ns


def span(i, name, parent, dev=None, counts=None):
    return {"name": name, "id": i, "parent": parent, "top": None, "host_enter_ns": 0,
            "host_exit_ns": 1, "device_enter_ns": None if dev is None else dev[0],
            "device_exit_ns": None if dev is None else dev[1],
            "counts": {k: {"n": n, "blocked_s": 0.0} for k, n in (counts or {}).items()}}


def forward(base, net_id, shifts):
    """One pass: a model.net span of ``len(shifts)`` blocks, each block's attn
    span of 2 ms (counting a shifted or a plain window attention) and mlp span
    of 1 ms, and a merge span, which neither reader reads."""
    out = [span(net_id, "model.net", base, (0, 10 * MS))]
    i = net_id
    for shifted in shifts:
        key = "window_attn.shifted" if shifted else "window_attn.plain"
        out.append(span(i + 1, "swin.attn", net_id, (0, 2 * MS), {key: 1}))
        out.append(span(i + 2, "swin.mlp", net_id, (2 * MS, 3 * MS)))
        i += 2
    out.append(span(i + 1, "swin.merge", net_id, (3 * MS, 4 * MS)))
    return out


# an attack step's forward with 3 blocks (one shifted) and a prediction's
# forward with 2 (one shifted): attn 10 ms over 2 passes, mlp 5 ms over 2,
# shifted 2 of 5; a ResNet forward beside them holds no Swin span
LOG = ([span(1, "attack", None, (0, 100 * MS)), span(2, "attack.step", 1, (0, 50 * MS)),
        span(3, "model.forward", 2, (0, 10 * MS))]
       + forward(3, 10, [False, True, False])
       + [span(30, "predict", None, (0, 10 * MS)), span(31, "model.forward", 30, (0, 10 * MS))]
       + forward(31, 40, [False, True])
       + [span(60, "model.net", 2, (0, 10 * MS), {"bn_fused": 49})])

CASES = [("window_attn_ms.eval", 5.0), ("swin_mlp_ms.eval", 2.5),
         ("shifted_window_share.eval", 40.0)]


@pytest.mark.parametrize("metric,value", CASES, ids=[c[0] for c in CASES])
def test_reader_on_a_hand_made_log(metric, value):
    reader = harness.load(f"metrics/{metric}")
    assert reader.read({"kind": "eval"}, LOG) == pytest.approx(value)
    assert reader.read({"kind": "train"}, LOG) is None
    on_cpu = [dict(s, device_enter_ns=None, device_exit_ns=None) for s in LOG]
    got = reader.read({"kind": "eval"}, on_cpu)
    assert got == pytest.approx(value) if metric.startswith("shifted") else got is None
    # a model without Swin's spans and counters (the other cells, the parent)
    assert reader.read({"kind": "eval"}, [s for s in LOG if not s["name"].startswith("swin.")
                                          and "window_attn.shifted" not in s["counts"]]) is None
    assert reader.read({"kind": "eval"}, []) is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_reader_without_the_programs_log_reads_nothing(metric, monkeypatch):
    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    reader = harness.load(f"metrics/{metric}")
    monkeypatch.delattr(profiling, "spans")
    assert reader.read({"kind": "eval"}) is None


def test_the_manifest_entries_of_the_cell():
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    (cell,) = [w for w in manifest["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "pgd10.b128"
    for name, _ in CASES:
        (entry,) = [m for m in manifest["per_layer"] if m["name"] == name]
        assert entry["layer"] == "models" and entry["moves"] == "eval_ex_per_s"
        assert entry["workloads"] == [CELL]
    reported = [m["name"] for m in manifest["per_layer"] if CELL in m.get("workloads", [])]
    assert reported == ["mfu.eval", "kernels_per_step.eval", "norm_copy_share.eval",
                        "pgd_step_roofline", "idle_share.eval", "syncs_per_step.eval",
                        "issue_ms_per_pass.eval", "starved_share.eval"] + [c[0] for c in CASES]


def test_the_config_matches_the_reference_spec_and_the_flop_count():
    config = json.loads((BENCH / "configs" / "swin_l-in224-bf16.json").read_text())
    ref, flops = harness.load("reference/swin"), harness.load("flops/swin")
    spec = ref.param_spec(config)
    assert sum(math.prod(shape) for _, shape, _, _ in spec) == config["parameters"]
    assert len({name for name, _, _, _ in spec}) == len(spec)
    assert config["embed_dim"] == 6 * 32 and [config["embed_dim"] * 2**s // h for s, h in
                                              enumerate(config["num_heads"])] == [32] * 4
    assert config["reduced"] == [] and config["zoo_name"] == "swin_l"
    assert flops.forward_macs(config) / 1e9 == pytest.approx(34.476, abs=5e-4)
    assert abs(flops.forward_macs(config) / 1e9 - config["published_gmac"]) < 0.05


TINY_SWIN = {"zoo_name": "swin_tiny_cell", "reference": "swin", "flops": "swin",
             "patch_size": 2, "embed_dim": 16, "depths": [2, 2], "num_heads": [2, 4],
             "window_size": 4, "mlp_ratio": 4, "num_classes": 10, "image_size": 32,
             "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225], "dtype": "float32",
             "reduced": []}


def test_a_tiny_swin_cell_runs_checked_and_traced_on_the_cpu(tmp_path, monkeypatch):
    from image_recognition_adversarial_example_attack_tpu_torch.models import swin, zoo

    monkeypatch.setitem(zoo._REGISTRY, "swin_tiny_cell", ("swin", swin.swin_tiny_test))
    folder = tmp_path / "benchmark_port"
    shutil.copytree(BENCH, folder, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (folder / "configs" / "tiny-swin.json").write_text(json.dumps(TINY_SWIN))
    (folder / "traffic" / "pgd3.b4.json").write_text(json.dumps(TRAFFIC["pgd3.b4"]))
    (folder / "limits" / "tiny.swin.pgd3.json").write_text(json.dumps(ATTACK_LIMITS))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-swin", "source": "https://arxiv.org/abs/2103.14030",
                                "file": "benchmark_port/configs/tiny-swin.json", "reduced": [],
                                "why": "a CPU test's cell"})
    manifest["workloads"].append({"name": "tiny.swin.pgd3", "config": "tiny-swin",
                                  "traffic": "pgd3.b4", "chips": 1, "why": "a CPU test's cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.swin.pgd3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    h = load_harness(folder)
    cell = h.Cell(manifest, "tiny.swin.pgd3", root=tmp_path, base=folder)
    out = h.run_cell(cell, 2**40 + 3, 0.2, True, device="cpu", t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for k, c in out["checks"].items() if k != "grad_sign_miss"
               and k != "logit_gap")
    metrics = out["metrics"]
    # swin_tiny_test shifts in both of its stages: 2 of its 4 window attentions
    assert metrics["shifted_window_share.eval"]["value"] == 50.0
    # no device events on the CPU: the device readers read nothing
    assert "window_attn_ms.eval" not in metrics and "swin_mlp_ms.eval" not in metrics
