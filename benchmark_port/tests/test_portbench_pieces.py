"""The benchmark's pieces on the CPU: the FLOP counters, the kernels' byte
counts, the trace reducers, the import check, and a new configuration,
traffic mix and per-layer metric found by their files alone."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, load_harness, run_tiny

harness = load_harness(BENCH)


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_flops_match_the_published_counts():
    resnet, vit = harness.load("flops/resnet"), harness.load("flops/vit")
    assert resnet.forward_macs(config("resnet50-in224-bf16")) / 1e9 == pytest.approx(4.09, abs=0.005)
    assert vit.forward_macs(config("vit_b_16-in224-bf16")) / 1e9 == pytest.approx(17.56, abs=0.01)
    # the detector's stages 1-3 of ResNet-50: the forward less stage 4 and the head
    c = config("resnet50-in224-bf16")
    # block 0's first 1x1 reads the 14x14 input; its 3x3 and projection stride to 7x7
    stage4 = 14 * 14 * 512 * 1024 + 7 * 7 * (512 * 512 * 9 + 512 * 2048 + 2048 * 1024) \
        + 2 * 7 * 7 * (512 * 2048 + 512 * 512 * 9 + 512 * 2048)
    assert resnet.stage3_macs(c) == resnet.forward_macs(c) - stage4 - 2048 * 1000


def test_parameter_specs_match_the_published_sizes():
    for name, ref in (("resnet50-in224-bf16", "resnet"), ("vit_b_16-in224-bf16", "vit")):
        c = config(name)
        spec = harness.load(f"reference/{ref}").param_spec(c)
        n = sum(_numel(s) for k, s, _, _ in spec if not k.endswith(
            (".running_mean", ".running_var", ".num_batches_tracked")))
        assert n == c["parameters"]


def _numel(shape):
    out = 1
    for s in shape:
        out *= s
    return out


def test_kernel_byte_counts():
    work = {"attack_numel": 128 * 224 * 224 * 3, "defended_numel": 128 * 224 * 224 * 3}
    pgd, quant = harness.load("kernels/pgd_step"), harness.load("kernels/quantize")
    assert pgd.bytes_per_call(work) == 4 * 4 * 19267584  # 3 reads + 1 write of float32
    assert quant.bytes_per_call(work) == 2 * 4 * 19267584
    assert quant.bytes_per_call({"attack_numel": 1}) is None
    # 92 us and 46 us at 3.35 TB/s, as the kernels' own docstring says
    assert pgd.bytes_per_call(work) / 3.35e12 == pytest.approx(92.0e-6, rel=0.01)


def test_trace_reducers_on_a_synthetic_trace():
    trace = harness.load("trace")
    kernels = [("void at::native::batch_norm_transform_input_channels_last_kernel", 0.0, 10.0),
               ("pgd_step_kernel", 5.0, 15.0),  # overlaps the first: counted once
               ("void cudnn::engines_precompiled::dgrad2d_kernel", 30.0, 40.0),
               ("void at::native::direct_copy_kernel_cuda", 50.0, 55.0),
               ("vectorized_layer_norm_kernel", 55.0, 60.0),
               ("void at::native::elementwise_kernel<add>", 70.0, 80.0)]
    spans = [("stretch", 0.0, 100.0), ("attack", 0.0, 45.0), ("predict", 45.0, 90.0)]
    s = trace.reduce_events(kernels, spans, 0.0, 100.0)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["kernel_count"] == 6
    assert s["by_class_s"]["batchnorm"] == pytest.approx(10e-6)
    assert s["by_class_s"]["layernorm"] == pytest.approx(5e-6)
    assert s["by_class_s"]["port kernels"] == pytest.approx(10e-6)
    assert s["by_class_s"]["conv input-gradient"] == pytest.approx(10e-6)
    assert s["by_class_s"]["copies and layout transforms"] == pytest.approx(5e-6)
    assert s["by_class_s"]["other elementwise"] == pytest.approx(10e-6)
    # each gap is named by the innermost host span open where it starts
    gaps = [(g[0], round(g[1] * 1e6)) for g in s["idle_gaps"]]
    assert gaps == [("predict", 20), ("attack", 15), ("attack", 10), ("predict", 10)]
    assert s["window_s"] == pytest.approx(100e-6)
    summary = dict(s, kind="eval", steps=2, peaks={}, units=1,
                   untraced={"seconds": 180e-6, "units": 2},
                   kernels={"pgd_step": {"calls": 1, "device_s": 10e-6, "least_s": 8e-6}})
    read = {n: harness.load(f"metrics/{n}").read(summary) for n in
            ("kernels_per_step.eval", "norm_copy_share.eval", "idle_share.eval",
             "pgd_step_roofline", "quantize_roofline", "kernels_per_step.train")}
    assert read["kernels_per_step.eval"] == 3.0
    assert read["norm_copy_share.eval"] == pytest.approx(100 * 20 / 50)
    assert read["idle_share.eval"] == pytest.approx(50.0)  # 45 us busy a unit of 90 us
    assert read["pgd_step_roofline"] == pytest.approx(80.0)
    assert read["quantize_roofline"] is None and read["kernels_per_step.train"] is None


def test_import_check_compares_whole_top_level_names(monkeypatch):
    port = "image_recognition_adversarial_example_attack_tpu_torch"
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, port + ".fake_submodule", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []  # a prefix is no match
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, port[:-len("_torch")] + ".core", sys)
    assert harness.forbidden_modules() == ["image_recognition_adversarial_example_attack_tpu.core",
                                           "jax.numpy"]


def test_a_run_loads_no_jax(tiny_bench):
    h, root, manifest = tiny_bench
    out = run_tiny(h, root, manifest, "tiny.pgd3", seconds=0.5)
    assert out["correct"], json.dumps(out["checks"])
    assert h.forbidden_modules() == []


def test_new_config_traffic_and_metric_are_found_by_their_files(tiny_bench):
    h, root, manifest = tiny_bench
    folder = root / "benchmark_port"
    cfg = json.loads((folder / "configs" / "tiny-resnet.json").read_text())
    cfg.update(image_size=48)  # the same zoo model at another input size
    (folder / "configs" / "tinier-resnet.json").write_text(json.dumps(cfg))
    traffic = json.loads((folder / "traffic" / "pgd3.b4.json").read_text())
    traffic.update(batch=2, steps=1)
    (folder / "traffic" / "pgd1.b2.json").write_text(json.dumps(traffic))
    (folder / "limits" / "tinier.pgd1.json").write_text(
        (folder / "limits" / "tiny.pgd3.json").read_text())
    (folder / "metrics" / "steps_seen.py").write_text(
        "def read(summary):\n    return float(summary['steps'])\n")
    manifest["configs"].append(dict(manifest["configs"][-1], name="tinier-resnet",
                                    file="benchmark_port/configs/tinier-resnet.json"))
    manifest["workloads"].append({"name": "tinier.pgd1", "config": "tinier-resnet",
                                  "traffic": "pgd1.b2", "chips": 1, "why": "added as files"})
    manifest["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "attack loop",
                                  "moves": "eval_ex_per_s", "workloads": ["tinier.pgd1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = run_tiny(h, root, manifest, "tinier.pgd1", trace=True, seconds=0.3)
    assert out["correct"], json.dumps(out["checks"])
    assert out["metrics"]["steps_seen"]["value"] == 1.0  # one traced unit of one PGD step
    assert "mfu.eval" in out["metrics"]
    assert "pgd_step_roofline" not in out["metrics"]  # no kernel ran on the CPU


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    cell = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, "benchmark_port/run.py", "--workload", cell,
                           "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
