"""The port's defense_experiments grid CLI on the CPU under its options: the
squeezing and Mahalanobis detectors with a detector-aware attacker,
--adaptive with a profile, --max_batch 0, --imagenet_val_dir and
--model_type robust."""

import json
import tempfile

import pytest

from _torch_cli_helpers import FAST, SUMMARY, one_thread, summary_lines, val_tree, write_images  # noqa: F401 (one_thread: autouse)
from image_recognition_adversarial_example_attack_tpu_torch.cli import common
from image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments import main


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    return write_images(tmp_path_factory.mktemp("imgs"))


def _run(argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("detector,message", [
    ("mahalanobis", "Fitting Mahalanobis detector on 3 clean images..."),
    ("squeezing", "Calibrating squeezing detector on 3 clean images...")])
def test_detector_runs(image_dir, tmp_path, capsys, detector, message):
    out = _run(["--image_dir", str(image_dir), "--attacks", "fgsm", "pgd", "--eps_list",
                "0.03137", "--detector", detector, "--detector_aware", "--viz_samples", "0",
                "--output_dir", str(tmp_path), *FAST], capsys)
    assert message in out and "Auto-calibrated threshold: " in out
    assert "[PGD Attack | eps=0.03137 | DETECTOR-AWARE]" in out
    lines = summary_lines(out)
    assert len(lines) == 2 and all(SUMMARY.match(line) for line in lines)


def test_mahalanobis_keeps_its_fit_under_a_given_threshold(image_dir, tmp_path, capsys):
    out = _run(["--image_dir", str(image_dir), "--attacks", "fgsm", "--eps_list", "0.03137",
                "--detector", "mahalanobis", "--detector_threshold", "7",
                "--viz_samples", "0", "--output_dir", str(tmp_path), *FAST], capsys)
    assert "Fitting Mahalanobis detector" in out and "Using specified threshold: 7.0000" in out


def test_adaptive_run_with_a_profile(image_dir, tmp_path, capsys):
    out = _run(["--image_dir", str(image_dir), "--attacks", "pgd", "--eps_list", "0.03137",
                "--adaptive", "--use_tv", "--tv_steps", "3", "--viz_samples", "1",
                "--profile-dir", str(tmp_path / "prof"),
                "--output_dir", str(tmp_path / "out"), *FAST], capsys)
    assert "[PGD Attack | eps=0.03137 | ADAPTIVE (through the defense)]" in out
    assert len(summary_lines(out)) == 1
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]


def test_max_batch_zero_keeps_one_batch(image_dir, tmp_path, capsys):
    out = _run(["--image_dir", str(image_dir), "--max_batch", "0", "--attacks", "fgsm",
                "--eps_list", "0.03137", "--viz_samples", "0", "--output_dir", str(tmp_path),
                *FAST], capsys)
    assert len(summary_lines(out)) == 1


def test_imagenet_val_dir_gives_ground_truth(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # where the labels go
    val = val_tree(tmp_path / "val")
    out = _run(["--imagenet_val_dir", str(val), "--attacks", "fgsm", "--eps_list", "0.03137",
                "--viz_samples", "0", "--output_dir", str(tmp_path / "out"), *FAST], capsys)
    assert "ImageNet-val ground truth: 3 images (2 named classes, 2 distinct labels)" in out
    assert "clean accuracy vs ground truth: " in out and len(summary_lines(out)) == 1
    with pytest.raises(SystemExit, match="replaces --image_dir"):
        main(["--imagenet_val_dir", str(val), "--image_dir", str(val), *FAST])


def test_robust_model_type(image_dir, tmp_path, capsys, monkeypatch):
    """--model_type robust loads resnet50_robust (random init here) with the
    identity normalization."""
    monkeypatch.setenv("ADV_TPU_WEIGHTS_DIR", str(tmp_path / "none"))
    seen = {}
    real = common.make_fns

    def spy(bundle):
        seen["bundle"] = bundle
        return real(bundle)

    monkeypatch.setattr("image_recognition_adversarial_example_attack_tpu_torch.cli."
                        "defense_experiments.make_fns", spy)
    argv = ["--image_dir", str(image_dir), "--model_type", "robust", "--attacks", "fgsm",
            "--eps_list", "0.03137", "--detector_threshold", "1.0", "--viz_samples", "0",
            "--device", "cpu", "--output_dir", str(tmp_path / "out")]
    with pytest.warns(UserWarning, match="no weights found for 'resnet50_robust'"):
        out = _run(argv, capsys)
    b = seen["bundle"]
    assert b.name == "resnet50_robust" and b.mean.tolist() == [0, 0, 0]
    assert b.std.tolist() == [1, 1, 1] and len(summary_lines(out)) == 1
