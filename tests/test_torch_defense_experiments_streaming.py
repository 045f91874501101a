"""The port's defense_experiments CLI streaming past --max_batch on the CPU
(resnet_tiny, ten 64x64 images resized to 224, chunks of 4: the last with
n_valid 2).  Both packages load the same weights from one Flax msgpack file
written by ``flax.serialization.to_bytes``."""

import io
import json
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
from flax import serialization

from _torch_cli_helpers import FAST, SUMMARY, summary_lines, write_images
from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet
from image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments import main

EPS_LIST = ["0.01", "0.012"]  # fgsm fools 3 and 8 of the 10 images
N = 10


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_cli")
    image_dir = root / "imgs"
    image_dir.mkdir()
    write_images(image_dir, n=N)
    _, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, seed=4)
    weights = root / "resnet_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(variables))
    base = ["--image_dir", str(image_dir), "--eps_list", *EPS_LIST, "--weights", str(weights),
            *FAST]
    return {"root": root, "base": base, "image_dir": image_dir}


def _run(argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(setup):
    """The default attacks streamed (with the sample figure) and resident."""
    out = {}
    for name, max_batch, viz in (("streamed", "4", "2"), ("resident", "0", "0")):
        out_dir = setup["root"] / name
        text = _run([*setup["base"], "--max_batch", max_batch, "--viz_samples", viz,
                     "--output_dir", str(out_dir)])
        out[name] = {"out": text, "dir": out_dir,
                     "partial": json.loads((out_dir / "results_partial.json").read_text())}
    return out


def test_streamed_grid_prints_what_the_resident_grid_prints(runs):
    streamed, resident = runs["streamed"], runs["resident"]
    assert f"Streaming evaluation: {N} images in fixed chunks of 4 " in streamed["out"]
    assert "Streaming evaluation" not in resident["out"]
    assert streamed["out"].count("streamed chunks of 4, one cell call each") == 5
    lines = summary_lines(streamed["out"])
    assert len(lines) == 6 and all(SUMMARY.match(ln) for ln in lines)
    # fgsm and cw are deterministic: byte-equal summary lines
    det = [ln for ln in lines if not ln.startswith("attack=pgd")]
    assert det == [ln for ln in summary_lines(resident["out"]) if not ln.startswith("attack=pgd")]
    assert len(det) == 4
    assert all(c["count"] == N for c in streamed["partial"].values())
    timings = json.loads((streamed["dir"] / "timings.json").read_text())
    assert len(timings) == 5 and all(t["examples"] == N for t in timings.values())
    assert (streamed["dir"] / "attack_samples.png").is_file()


def test_streamed_grid_resumes_every_cell(runs, setup, tmp_path):
    out_dir = tmp_path / "resumed"
    shutil.copytree(runs["streamed"]["dir"], out_dir)
    out = _run([*setup["base"], "--max_batch", "4", "--viz_samples", "0", "--resume",
                "--output_dir", str(out_dir)])
    assert out.count("(resumed from partial results)") == 6
    assert summary_lines(out) == summary_lines(runs["streamed"]["out"])


def test_labels_resolve_per_chunk(runs, setup, tmp_path):
    """A labels file that names every other image: the streamed path fills
    the rest with each chunk's pseudo-labels, as the resident path does."""
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({f"img_{i}.jpg": (3 * i) % 10 for i in range(0, N, 2)}))
    lines = []
    for max_batch in ("4", "0"):
        out = _run([*setup["base"], "--attacks", "fgsm", "--labels_json", str(labels),
                    "--max_batch", max_batch, "--viz_samples", "0",
                    "--output_dir", str(tmp_path / max_batch)])
        lines.append(summary_lines(out))
    assert lines[0] == lines[1] and len(lines[0]) == 2


def test_streamed_counters_equal_the_jax_cli(runs, setup, tmp_path, capsys):
    """The JAX CLI streams the same images at --max_batch 4 from the same
    msgpack file: its fgsm and cw counters equal the port's."""
    from image_recognition_adversarial_example_attack_tpu.cli import defense_experiments as jax_cli

    base = [a for a in setup["base"] if a not in ("--device", "cpu")]
    out_dir = tmp_path / "jax"
    assert jax_cli.main([*base, "--attacks", "fgsm", "cw", "--max_batch", "4",
                         "--viz_samples", "0", "--output_dir", str(out_dir)]) == 0
    assert "Streaming evaluation" in capsys.readouterr().out
    theirs = json.loads((out_dir / "results_partial.json").read_text())
    ours = runs["streamed"]["partial"]
    keys = [f"{a}:{float(e):.6f}" for a in ("fgsm", "cw") for e in EPS_LIST]
    for k in keys:
        assert {s: v for s, v in ours[k].items() if s != "config_fp"} == {
            s: v for s, v in theirs[k].items() if s != "config_fp"}, k
