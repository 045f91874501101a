"""The port's defense_experiments grid CLI on the CPU (resnet_tiny, three
64x64 images resized to 224, two PGD steps, four CW steps): the default
grid, resume, grid-position independence, thresholds and refusals."""

import io
import json
import shutil
from contextlib import redirect_stdout

import pytest
import torch
from PIL import Image

from _torch_cli_helpers import FAST, SUMMARY, one_thread, summary_lines, write_images  # noqa: F401 (one_thread: autouse)
from image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments import (
    build_parser, main)

EPS_LIST = ["0.03137", "0.06275"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    return write_images(tmp_path_factory.mktemp("imgs"))


def _run(argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def grid(image_dir, tmp_path_factory):
    """The default three attacks over two eps, with the sample figure."""
    out_dir = tmp_path_factory.mktemp("grid")
    argv = ["--image_dir", str(image_dir), "--eps_list", *EPS_LIST, "--viz_samples", "2",
            "--output_dir", str(out_dir), *FAST]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return {"out": buf.getvalue(), "dir": out_dir, "argv": argv}


def test_grid_prints_the_summary_and_writes_its_files(grid):
    out, out_dir = grid["out"], grid["dir"]
    lines = summary_lines(out)
    assert len(lines) == 6 and all(SUMMARY.match(line) for line in lines), lines
    assert [SUMMARY.match(line).groups() for line in lines] == [
        (a, e) for a in ("cw", "fgsm", "pgd") for e in ("0.03137", "0.06275")]
    assert "Auto-calibrated threshold: " in out and "Loaded image directory: " in out
    # cw does not read eps: computed once, reused for the second eps
    assert out.count("(cw is eps-independent: reusing the computed cell)") == 1
    partial = json.loads((out_dir / "results_partial.json").read_text())
    assert sorted(partial) == sorted(f"{a}:{float(e):.6f}" for a in ("fgsm", "pgd", "cw")
                                     for e in EPS_LIST)
    assert all(c["count"] == 3 and len(c["config_fp"]) == 16 for c in partial.values())
    assert partial["cw:0.031370"] == partial["cw:0.062750"]
    for name in ("defense_results_attack_trend.png", "defense_results_defense_matrix.png",
                 "attack_samples.png"):
        with Image.open(out_dir / name) as im:
            assert im.format == "PNG" and im.width > 500
    timings = json.loads((out_dir / "timings.json").read_text())
    assert sorted(timings) == sorted(k for k in partial if k != "cw:0.062750")
    assert all(t["examples"] == 3 and t["seconds"] > 0 for t in timings.values())


def test_resume_reuses_every_cell(grid, tmp_path, capsys):
    out_dir = tmp_path / "copy"
    shutil.copytree(grid["dir"], out_dir)
    argv = [*grid["argv"], "--resume", "--viz_samples", "0", "--output_dir", str(out_dir)]
    out = _run(argv, capsys)
    assert out.count("(resumed from partial results)") == 6
    assert summary_lines(out) == summary_lines(grid["out"])
    # another cw knob recomputes the cw cells only
    out = _run([*argv, "--cw_kappa", "0.5"], capsys)
    assert out.count("(resumed from partial results)") == 4
    assert out.count("(cw is eps-independent: reusing the computed cell)") == 1


def test_a_cell_does_not_depend_on_its_place_in_the_grid(grid, image_dir, tmp_path, capsys):
    """A fresh run of a narrower grid reproduces the wide grid's cells, so
    resuming them is sound (core.rng.cell_generator)."""
    _run(["--image_dir", str(image_dir), "--attacks", "pgd", "cw", "--eps_list", EPS_LIST[1],
          "--viz_samples", "0", "--output_dir", str(tmp_path), *FAST], capsys)
    wide = json.loads((grid["dir"] / "results_partial.json").read_text())
    narrow = json.loads((tmp_path / "results_partial.json").read_text())
    assert narrow["pgd:0.062750"] == wide["pgd:0.062750"]
    assert narrow["cw:0.062750"] == wide["cw:0.062750"]


def test_threshold_messages(image_dir, tmp_path, capsys):
    base = ["--image_dir", str(image_dir), "--attacks", "fgsm", "--eps_list", "0.03137",
            "--viz_samples", "0", *FAST]
    out = _run([*base, "--calibrate_dir", str(image_dir), "--calibrate_n", "2",
                "--output_dir", str(tmp_path / "c1")], capsys)
    assert "Calibrating detector threshold on 2 clean images..." in out
    assert "Using calibrated threshold: " in out
    out = _run([*base, "--detector_threshold", "2.5", "--output_dir", str(tmp_path / "c2")],
               capsys)
    assert "Using specified threshold: 2.5000" in out and "Calibrating" not in out


def test_detector_aware_refuses_cw_before_any_work(capsys):
    with pytest.raises(SystemExit, match="detector_aware"):
        main(["--image", "does_not_matter.jpg", "--attacks", "cw", "--detector_aware",
              "--device", "cpu"])


def test_streaming_is_refused_before_any_device_work(image_dir, tmp_path, monkeypatch):
    """Streaming is ported: an image set above --max_batch is no longer
    refused before the device work, the run goes on to the device (the
    streamed grid itself: tests/test_torch_defense_experiments_streaming.py)."""
    cli = "image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments"

    class ReachedTheDevice(Exception):
        pass

    def reached(*args):
        raise ReachedTheDevice

    monkeypatch.setattr(f"{cli}.resolve_device", reached)
    with pytest.raises(ReachedTheDevice):
        main(["--image_dir", str(image_dir), "--max_batch", "2", "--output_dir", str(tmp_path)])


def test_cuda_is_the_default_and_raises_without_it(image_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--image_dir", str(image_dir), "--model", "resnet_tiny",
              "--output_dir", str(tmp_path)])


def test_labels_json_range_is_checked(image_dir, tmp_path):
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"img_0.jpg": 10}))  # resnet_tiny has 10 classes
    with pytest.raises(SystemExit, match=r"out-of-range class ids \[10\]"):
        main(["--image_dir", str(image_dir), "--labels_json", str(labels), "--viz_samples", "0",
              "--output_dir", str(tmp_path / "out"), *FAST])


def test_parser_keeps_the_jax_flags_of_the_ported_attacks():
    """The same flags and defaults as the JAX CLI (the extended-attack flags
    and --square_steps included), less the options of unported paths, plus
    --device."""
    from image_recognition_adversarial_example_attack_tpu.cli import defense_experiments as jx

    left_out = {"cifar10_dir", "cifar10_split", "cifar10_n"}
    ours = {a.dest: a.default for a in build_parser()._actions}
    theirs = {a.dest: a.default for a in jx.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) - set(ours) == left_out
    assert {k for k in ours if k in theirs and ours[k] != theirs[k]} == set()
    attacks = next(a for a in build_parser()._actions if a.dest == "attacks")
    theirs_attacks = next(a for a in jx.build_parser()._actions if a.dest == "attacks")
    assert attacks.choices == theirs_attacks.choices
    assert attacks.default == ["fgsm", "pgd", "cw"]
    certified = next(a for a in build_parser()._actions if a.dest == "certified")
    theirs_certified = next(a for a in jx.build_parser()._actions if a.dest == "certified")
    assert certified.choices == theirs_certified.choices == ["off", "ibp", "crown-ibp"]
