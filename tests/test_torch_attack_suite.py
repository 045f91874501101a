"""The attack_suite CLI of the port (cli/attack_suite.py,
eval/streaming.py::stream_suite_attack) against the JAX package's on the
CPU, and the white-box zoo through the four CLIs that existed before it.

The suite CLIs of both packages load the same resnet_tiny weights from one
Flax msgpack file and read the same three PNGs: the table's header, the
pseudo-label note, the JSON keys, the counts and the rows of the
deterministic attacks (fgsm, deepfool, jsma) agree; apgd's random start has
other bits in each package, so only its row's keys and bounds are held.
"""

import argparse
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
from flax import serialization

from _torch_cli_helpers import write_images
from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet
from image_recognition_adversarial_example_attack_tpu.cli import attack_suite as jax_suite
from image_recognition_adversarial_example_attack_tpu_torch.cli import attack_suite

SMALL = ["--steps", "2", "--deepfool_steps", "2", "--deepfool_classes", "3",
         "--jsma_steps", "3", "--n_target_classes", "2", "--eps", "0.02"]
ROW_KEYS = {"attack", "asr", "linf", "l2_mean", "changed_pct", "ssim", "psnr", "ece",
            "compile_run_s", "steady_s"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("suite")
    images = root / "imgs"
    images.mkdir()
    write_images(images, n=3, size=48)
    _, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, seed=6)
    weights = root / "resnet_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(variables))
    base = ["--image_dir", str(images), "--model", "resnet_tiny", "--weights", str(weights),
            *SMALL]
    return {"root": root, "images": images, "base": base}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _table(out: str) -> tuple[str, dict[str, list[str]]]:
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("attack "))
    rows = {}
    for ln in lines[head + 2:]:
        if not ln.strip() or ln.startswith("clean ECE"):
            break
        rows[ln.split()[0]] = ln.split()
    return lines[head], rows


# the four attacks in two runs of each CLI (a run compiles each of its attacks)
GROUPS = {"fgsm+apgd": ["fgsm", "apgd"], "deepfool+jsma": ["deepfool", "jsma"]}


@pytest.fixture(scope="module", params=list(GROUPS))
def suites(request, setup):
    names = GROUPS[request.param]
    out = {"names": names}
    for who, main, extra in (("ours", attack_suite.main, ["--device", "cpu"]),
                             ("theirs", jax_suite.main, [])):
        path = setup["root"] / f"{who}_{request.param}.json"
        text = _run(main, [*setup["base"], "--attacks", *names, "--output", str(path), *extra])
        out[who] = {"text": text, "json": json.loads(path.read_text())}
    return out


def test_table_and_json_are_the_jax_clis(suites):
    ours, theirs = suites["ours"], suites["theirs"]
    head_o, rows_o = _table(ours["text"])
    head_t, rows_t = _table(theirs["text"])
    assert head_o == head_t == attack_suite.HEADER
    assert attack_suite.PSEUDO_NOTE in ours["text"] and attack_suite.PSEUDO_NOTE in theirs["text"]
    assert list(rows_o) == list(rows_t) == suites["names"]
    assert set(ours["json"]) == set(theirs["json"])
    for k in ("count", "eps", "model", "labels"):
        assert ours["json"][k] == theirs["json"][k], k
    assert ours["json"]["ece_clean"] == pytest.approx(theirs["json"]["ece_clean"], abs=1e-5)
    for row_o, row_t in zip(ours["json"]["results"], theirs["json"]["results"]):
        assert set(row_o) == set(row_t) == ROW_KEYS
        if row_o["attack"] == "apgd":
            assert row_o["linf"] <= 0.02 + 1e-6 and 0.0 <= row_o["asr"] <= 1.0
            continue
        # the deterministic attacks: the same table row, to float32 rounding
        assert row_o["asr"] == row_t["asr"], row_o["attack"]
        for k in ("linf", "l2_mean", "changed_pct", "ssim", "psnr", "ece"):
            assert row_o[k] == pytest.approx(row_t[k], rel=1e-3, abs=1e-4), (row_o["attack"], k)
        assert rows_o[row_o["attack"]][:8] == rows_t[row_t["attack"]][:8]


def test_streamed_rows_equal_the_one_batch_rows(setup):
    """Three images in chunks of two (the second with n_valid 1): the
    deterministic rows and the counts equal the one-batch run's."""
    out = {}
    for who, extra in (("one", []), ("streamed", ["--max_batch", "2"])):
        path = setup["root"] / f"port_{who}.json"
        text = _run(attack_suite.main, [*setup["base"], "--attacks", "fgsm", "deepfool",
                                        "--output", str(path), "--device", "cpu", *extra])
        out[who] = (text, json.loads(path.read_text()))
    text, streamed = out["streamed"]
    one = out["one"][1]
    assert "3 images STREAMED in fixed chunks of 2" in text
    assert streamed["streamed"] is True and streamed["max_batch"] == 2
    assert streamed["count"] == streamed["requested"] == one["count"] == 3
    assert set(streamed) - set(one) == {"requested", "streamed", "max_batch"}
    assert streamed["ece_clean"] == pytest.approx(one["ece_clean"], abs=1e-6)
    for row_s, row_1 in zip(streamed["results"], one["results"]):
        assert row_s["asr"] == row_1["asr"] and row_s["linf"] == row_1["linf"]
        for k in ("l2_mean", "changed_pct", "ssim", "psnr", "ece"):
            assert row_s[k] == pytest.approx(row_1[k], rel=1e-5, abs=1e-6), k


def test_all_runs_the_25_names(setup):
    """``all`` is the JAX tuple, every name of ``run_attack``: at tiny
    budgets the table has its 25 rows, each attack's two calls bit-equal
    (the CLI refuses them otherwise)."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import ATTACK_NAMES

    assert attack_suite.ALL_ATTACKS == jax_suite.ALL_ATTACKS
    assert set(attack_suite.ALL_ATTACKS) == set(ATTACK_NAMES) and len(ATTACK_NAMES) == 25
    tiny = ["--steps", "1", "--cw_steps", "2", "--square_steps", "3", "--deepfool_steps", "1",
            "--deepfool_classes", "2", "--est_samples", "1", "--bandits_steps", "2",
            "--hsja_steps", "1", "--hsja_probes", "2", "--boundary_steps", "2",
            "--simba_steps", "2", "--jsma_steps", "2", "--stadv_steps", "2",
            "--spatial_candidates", "2", "--n_target_classes", "2"]
    path = setup["root"] / "all.json"
    text = _run(attack_suite.main, [*setup["base"], *tiny, "--attacks", "all", "--device",
                                    "cpu", "--output", str(path)])
    _, rows = _table(text)
    assert list(rows) == list(attack_suite.ALL_ATTACKS)
    results = json.loads(path.read_text())["results"]
    assert [r["attack"] for r in results] == list(attack_suite.ALL_ATTACKS)
    assert all(set(r) == ROW_KEYS and 0.0 <= r["asr"] <= 1.0 for r in results)


def test_reruns_that_differ_are_refused(setup, monkeypatch):
    """The two timed calls of an attack must be bit-equal."""
    calls = iter([0.0, 1e-7])
    real = attack_suite.run_attack
    monkeypatch.setattr(attack_suite, "run_attack",
                        lambda *a, **k: real(*a, **k) + next(calls))
    with pytest.raises(RuntimeError, match="fgsm: two runs from the same generator differ"):
        _run(attack_suite.main, [*setup["base"], "--attacks", "fgsm", "--device", "cpu",
                                 "--output", str(setup["root"] / "x.json")])


def test_parser_keeps_the_jax_flags():
    ours = {a.dest: a.default for a in attack_suite.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_suite.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) - set(ours) == set()
    assert {k for k in ours if ours[k] != theirs.get(k, ours[k])} == set()
    choices = next(a for a in attack_suite.build_parser()._actions if a.dest == "attacks")
    assert choices.choices == next(a for a in jax_suite.build_parser()._actions
                                   if a.dest == "attacks").choices


# ---------------------------------------------------------------------------
# the four CLIs that existed before the suite, one new attack each, with
# extended flags
# ---------------------------------------------------------------------------

CPU = ["--device", "cpu", "--model", "resnet_tiny"]


@pytest.mark.parametrize("cli", ["classify", "grid", "blackbox", "transferability"])
def test_existing_clis_run_a_white_box_attack_with_extended_flags(cli, setup, tmp_path):
    from image_recognition_adversarial_example_attack_tpu_torch.cli import (
        blackbox_transfer, classify, defense_experiments, transferability)

    images = setup["images"]
    if cli == "classify":
        out = _run(classify.main, [str(images / "img_0.jpg"), "--attack", "jsma",
                                   "--jsma_steps", "2", "--jsma_theta", "0.5", *CPU])
        assert "Adversarial (jsma):" in out
    elif cli == "grid":
        out = _run(defense_experiments.main, [
            "--image_dir", str(images), "--attacks", "deepfool", "fab", "--eps_list", "0.02",
            "0.03", "--deepfool_steps", "2", "--deepfool_classes", "3", "--steps", "2",
            "--viz_samples", "0", "--output_dir", str(tmp_path / "grid"), *CPU])
        lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
        assert [ln.split(",")[0] for ln in lines] == ["attack=deepfool"] * 2 + ["attack=fab"] * 2
        assert "(deepfool is eps-independent: reusing the computed cell)" in out
        assert lines[0].split(", ", 2)[2] == lines[1].split(", ", 2)[2]
    elif cli == "blackbox":
        out = _run(blackbox_transfer.main, [
            "--image_dir", str(images), "--source", "resnet_tiny", "--targets", "tiny",
            "--attacks", "pgd_l1", "--l1_sparsity", "0.05", "--eps", "2.0", "--steps", "2",
            "--visualize_n", "0", *CPU[:2]])
        assert "PGD_L1" in out.upper()
    else:
        _run(transferability.main, [
            "--image_dir", str(images), "--source_model", "resnet_tiny", "--target_models",
            "tiny", "--attacks", "spatial", "--spatial_candidates", "2", "--spatial_max_rot",
            "10", "--eps_list", "0.02", "0.03", "--convention", "blackbox",
            "--output_dir", str(tmp_path / "tr"), *CPU[:2]])
        results = json.loads((tmp_path / "tr" / "transfer_results.json").read_text())
        assert list(results) == ["spatial"] and len(results["spatial"]) == 2


def test_extended_kwargs_fill_attack_params():
    """Every extended flag reaches AttackParams and DefenseEvalConfig under
    its own name, as in the JAX CLIs."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import AttackParams
    from image_recognition_adversarial_example_attack_tpu_torch.cli import common
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig)

    parser = argparse.ArgumentParser()
    common.add_extended_attack_args(parser)
    kw = common.extended_attack_kwargs(parser.parse_args(["--jsma_steps", "7",
                                                          "--simba_mode", "pixel"]))
    assert kw["jsma_steps"] == 7 and kw["simba_mode"] == "pixel"
    assert set(kw) == set(AttackParams.__dataclass_fields__) - {
        "eps", "alpha", "steps", "cw_c", "cw_kappa", "cw_steps", "cw_lr", "random_start", "mu",
        "square_steps", "n_target_classes"}
    params = DefenseEvalConfig(attack_name="jsma", eps=0.1, alpha=0.01, steps=3,
                               square_steps=9, **kw).attack_params()
    assert params.jsma_steps == 7 and params.square_steps == 9 and params.simba_mode == "pixel"
