"""The port's transfer CLIs (cli/blackbox_transfer.py, cli/transferability.py)
and the test-set diagnostic (cli/dataset_check.py) on the CPU, against the
JAX CLIs: resnet_tiny as the source, the tiny CNN as the target, three 64x64
images resized to 224.  Both packages load the same weights from Flax msgpack
files in ``$ADV_TPU_WEIGHTS_DIR``."""

import io
import json
import re
import shutil
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from _torch_cli_helpers import one_thread, write_images  # noqa: F401 (one_thread: autouse)
from _torch_port_helpers import flax_resnet
from image_recognition_adversarial_example_attack_tpu.cli import blackbox_transfer as jax_bb
from image_recognition_adversarial_example_attack_tpu.cli import dataset_check as jax_dc
from image_recognition_adversarial_example_attack_tpu.cli import transferability as jax_tr
from image_recognition_adversarial_example_attack_tpu.models.tiny import TinyCNN
from image_recognition_adversarial_example_attack_tpu_torch.cli import blackbox_transfer as bb
from image_recognition_adversarial_example_attack_tpu_torch.cli import dataset_check as dc
from image_recognition_adversarial_example_attack_tpu_torch.cli import transferability as tr
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

CPU = ["--device", "cpu"]
# the targets' own labels (the source's 10 classes would make every 1000-class
# target's label a success under the source-label convention); at these eps
# fgsm flips 0 and 2 of the 3 source labels, 0 and 3 of the target's
TR = ["--source_model", "resnet_tiny", "--target_models", "tiny", "--attacks", "fgsm",
      "--eps_list", "0.05", "0.1", "--convention", "blackbox"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("transfer_cli")
    weights = root / "weights"
    weights.mkdir()
    _, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, size=224, seed=6)
    (weights / "resnet_tiny.msgpack").write_bytes(serialization.to_bytes(variables))
    tiny = TinyCNN(num_classes=1000)
    tiny_vars = jax.jit(tiny.init)(jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3)))
    (weights / "tiny.msgpack").write_bytes(serialization.to_bytes(jax.device_get(tiny_vars)))
    images = root / "imgs"
    images.mkdir()
    write_images(images, n=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADV_TPU_WEIGHTS_DIR", str(weights))
        yield {"root": root, "weights": weights, "images": images}


@pytest.fixture(autouse=True)
def _weights(setup):
    """Every test loads the shared files (and no random init)."""


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return buf.getvalue()


def _copy(setup, name):
    d = setup["root"] / name
    if not d.exists():
        shutil.copytree(setup["images"], d)
    return d


def _table(out: str) -> list[str]:
    lines = out.splitlines()
    return lines[lines.index(next(ln for ln in lines if ln.startswith("Attack/Model"))):]


def test_blackbox_table_equals_the_jax_clis(setup):
    argv = ["--attacks", "fgsm", "--source", "resnet_tiny", "--targets", "tiny",
            "--visualize_n", "1", "--eps", "0.1"]
    ours = _run(bb.main, ["--image_dir", str(_copy(setup, "bb_port")), *argv, *CPU])
    theirs = _run(jax_bb.main, ["--image_dir", str(_copy(setup, "bb_jax")), *argv])
    assert _table(ours) == _table(theirs)
    assert _table(ours) == ["Attack/Model\ttiny", "FGSM\t100.0%"]
    assert (setup["root"] / "bb_port" / "blackbox_vis" / "img_0_fgsm.png").is_file()


def test_blackbox_streamed_equals_resident(setup):
    argv = ["--image_dir", str(_copy(setup, "bb_stream")), "--attacks", "fgsm", "pgd", "cw",
            "--source", "resnet_tiny", "--targets", "tiny", "resnet_tiny", "--steps", "2",
            "--cw_steps", "3", "--visualize_n", "2", *CPU]
    streamed = _run(bb.main, [*argv, "--max_batch", "2"])
    resident = _run(bb.main, [*argv, "--max_batch", "0"])
    assert "Streaming evaluation: 3 images in fixed chunks of 2" in streamed
    assert _table(streamed)[0] == "Attack/Model\ttiny\tresnet_tiny"
    # fgsm and cw are deterministic; pgd's chunks draw their own random starts
    det = [ln for ln in _table(streamed) if not ln.startswith("PGD")]
    assert det == [ln for ln in _table(resident) if not ln.startswith("PGD")]
    vis = setup["root"] / "bb_stream" / "blackbox_vis"
    assert sorted(p.name for p in vis.iterdir()) == sorted(
        f"img_{i}_{a}.png" for i in range(2) for a in ("fgsm", "pgd", "cw"))


def test_blackbox_panels_fall_back_where_the_image_dir_is_read_only(setup, tmp_path,
                                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bb.os, "access", lambda path, mode: False)
    assert bb._vis_dir(setup["images"]) == bb.Path("blackbox_vis")
    assert (tmp_path / "blackbox_vis").is_dir()


@pytest.fixture(scope="module")
def transfer_runs(setup):
    out = {}
    for name, main, extra in (("port", tr.main, [*CPU, "--save_adv_images"]),
                              ("jax", jax_tr.main, [])):
        out_dir = setup["root"] / f"tr_{name}"
        text = _run(main, [*TR, "--image_dir", str(setup["images"]), "--output_dir",
                           str(out_dir), *extra])
        out[name] = {"out": text, "dir": out_dir,
                     "json": json.loads((out_dir / "transfer_results.json").read_text())}
    return out


def test_transfer_results_equal_the_jax_clis(transfer_runs):
    ours, theirs = transfer_runs["port"], transfer_runs["jax"]
    assert ours["json"] == theirs["json"]
    assert list(ours["json"]["fgsm"]) == ["0.05", "0.1"]
    assert sum(ours["json"]["fgsm"]["0.1"]["source_success"]) == 2
    summary = ours["out"][ours["out"].index("TRANSFERABILITY SUMMARY"):]
    assert summary.splitlines()[:5] == theirs["out"][
        theirs["out"].index("TRANSFERABILITY SUMMARY"):].splitlines()[:5]
    assert (ours["dir"] / "transfer_heatmap_fgsm.png").is_file()
    assert sorted(p.name for p in (ours["dir"] / "fgsm_eps_0.05000").iterdir()) == [
        f"adv_img_{i}.png" for i in range(3)]


def test_transfer_streamed_and_ensemble_equal_resident(setup, transfer_runs):
    """Streamed at --max_batch 2 (a padded tail) the record is the resident
    one; an ensemble of the source with itself attacks the same logits."""
    out_dir = setup["root"] / "tr_stream"
    text = _run(tr.main, [*TR, "--image_dir", str(setup["images"]), "--max_batch", "2",
                          "--output_dir", str(out_dir), *CPU])
    assert "Streaming evaluation: 3 images in fixed chunks of 2" in text
    assert json.loads((out_dir / "transfer_results.json").read_text()) == \
        transfer_runs["port"]["json"]
    out_dir = setup["root"] / "tr_ensemble"
    text = _run(tr.main, [*TR[:2], "resnet_tiny", *TR[2:], "--image_dir", str(setup["images"]),
                          "--output_dir", str(out_dir), *CPU])
    assert "Attacking a logit-fusion ensemble of 2 sources" in text
    assert json.loads((out_dir / "transfer_results.json").read_text()) == \
        transfer_runs["port"]["json"]


def test_cw_is_computed_once_per_sweep(setup):
    out_dir = setup["root"] / "tr_cw"
    text = _run(tr.main, ["--source_model", "resnet_tiny", "--target_models", "tiny",
                          "--attacks", "cw", "--cw_steps", "3", "--eps_list", "0.01", "0.02",
                          "0.03", "--image_dir", str(setup["images"]), "--output_dir",
                          str(out_dir), *CPU])
    assert text.count("(cw is eps-independent: reusing the computed cell)") == 2
    cells = json.loads((out_dir / "transfer_results.json").read_text())["cw"]
    assert len(cells) == 3 and len({json.dumps(c) for c in cells.values()}) == 1


@pytest.mark.parametrize("case", ["unknown", "mixed"])
def test_model_refusals_exit_2(setup, monkeypatch, capsys, case):
    if case == "unknown":
        argv, match = ["--source_model", "resnet_tiny", "--target_models", "nope"], "unknown model"
    else:
        real = zoo.model_meta
        monkeypatch.setattr(zoo, "model_meta", lambda n: {**real(n), "input_size": 32}
                            if n == "tiny" else real(n))
        argv, match = ["--source_model", "resnet_tiny", "--target_models", "tiny"], "mixed input"
    assert tr.main([*argv, "--image_dir", str(setup["images"]), *CPU]) == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("cli", ["blackbox", "transferability"])
def test_black_box_attacks_reach_the_device(setup, cli):
    """Asked for the card (absent here), every ``--attacks`` choice of the
    JAX CLI, the black-box ones included, gets past the arguments to the
    device rule: nothing refuses an attack before it."""
    main = bb.main if cli == "blackbox" else tr.main
    choices = next(a.choices for a in (bb if cli == "blackbox" else tr).build_parser()._actions
                   if a.dest == "attacks")
    theirs = next(a.choices for a in (jax_bb if cli == "blackbox" else jax_tr).build_parser()
                  ._actions if a.dest == "attacks")
    assert list(choices) == list(theirs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--image_dir", str(setup["images"]), "--attacks", *choices, "--device", "cuda"])


def _rows(out: str) -> dict[str, tuple]:
    rows = {}
    for line in out.splitlines():
        m = re.match(r"^(img_\d\.jpg)\s+(.{18}) (\d\.\d{4})\s+(\d\.\d{4})\s+(\w+)\s+(OK|LOW)", line)
        if m:
            rows[m[1]] = (m[2].strip(), float(m[3]), float(m[4]), m[5], m[6])
    return rows


@pytest.mark.parametrize("threshold", ["0.7", "0.05"])
def test_dataset_check_equals_the_jax_cli(setup, threshold):
    argv = ["--test_dir", str(setup["images"]), "--model", "resnet_tiny", "--threshold",
            threshold, "--topk", "3"]
    ours, theirs = _run(dc.main, [*argv, *CPU]), _run(jax_dc.main, argv)
    mine, want = _rows(ours), _rows(theirs)
    assert mine.keys() == want.keys() and len(mine) == 3
    for name, row in mine.items():
        assert (row[0], row[3], row[4]) == (want[name][0], want[name][3], want[name][4])
        assert abs(row[1] - want[name][1]) <= 1e-4 and abs(row[2] - want[name][2]) <= 1e-4
    tail = [ln for ln in ours.splitlines() if ln.startswith(("Total", "High", "Low-confidence i",
                                                             "Test-set", "WARNING"))]
    assert tail == [ln for ln in theirs.splitlines() if ln.startswith(
        ("Total", "High", "Low-confidence i", "Test-set", "WARNING"))]
    assert "Total images: 3" in ours


def test_dataset_check_isolates_a_bad_file(setup, tmp_path):
    d = tmp_path / "set"
    shutil.copytree(setup["images"], d / "sub")
    (d / "broken.jpg").write_bytes(b"not a jpeg")
    out = _run(dc.main, ["--test_dir", str(d), "--model", "resnet_tiny", *CPU])
    assert "FAILED to load broken.jpg" in out and "Total images: 3" in out
    assert dc.main(["--test_dir", str(tmp_path / "missing"), *CPU]) == 1
