"""The grid CLI's plumbing in the port (cell ids and generators, resume
fingerprints, labels, image inputs, ImageNet-val ground truth, the phase
timer, the plotted values) against the JAX package where it has a
counterpart (CPU)."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_cli_helpers import val_tree, write_images
from image_recognition_adversarial_example_attack_tpu.cli import common as jax_common
from image_recognition_adversarial_example_attack_tpu.core import datasets as jax_datasets
from image_recognition_adversarial_example_attack_tpu.utils import profiling as jax_profiling
from image_recognition_adversarial_example_attack_tpu_torch.attacks import ATTACK_NAMES
from image_recognition_adversarial_example_attack_tpu_torch.cli import common
from image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments import build_parser
from image_recognition_adversarial_example_attack_tpu_torch.core import datasets, rng
from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
from image_recognition_adversarial_example_attack_tpu_torch.utils.profiling import PhaseTimer
from image_recognition_adversarial_example_attack_tpu_torch.viz import plots


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    return write_images(tmp_path_factory.mktemp("imgs"))


def test_cell_rng_id_and_generator():
    assert common.cell_rng_id("cw", 0.01) == common.cell_rng_id("cw", 0.1) == "cw:epsfree"
    for name in ("fgsm", "pgd", "cw"):
        assert common.cell_rng_id(name, 0.0313725) == jax_common.cell_rng_id(name, 0.0313725)
    assert common.cell_rng_id("pgd", 0.01) != common.cell_rng_id("pgd", 0.1)
    assert common.EPS_INDEPENDENT_ATTACKS == jax_common.EPS_INDEPENDENT_ATTACKS == (
        "cw", "deepfool", "ead", "stadv", "boundary", "simba", "jsma", "spatial")
    # hsja reads no eps, but its cell id (with eps) seeds it, as in JAX
    assert common.cell_rng_id("hsja", 0.5) == jax_common.cell_rng_id("hsja", 0.5) != \
        common.cell_rng_id("hsja", 0.25)
    for name in ATTACK_NAMES:
        assert common.cell_rng_id(name, 0.5) == jax_common.cell_rng_id(name, 0.5)
    # the knob map is JAX's, every attack of the registry in it
    assert common.ATTACK_KNOB_ARGS == jax_common.ATTACK_KNOB_ARGS
    assert set(common.ATTACK_KNOB_ARGS) == set(ATTACK_NAMES)
    assert common._ALL_KNOB_ARGS == jax_common._ALL_KNOB_ARGS

    def draw(seed, cell):
        return torch.rand(4, generator=rng.cell_generator(seed, cell))

    assert torch.equal(draw(0, "pgd:0.031373"), draw(0, "pgd:0.031373"))
    assert not torch.equal(draw(0, "pgd:0.031373"), draw(1, "pgd:0.031373"))
    assert not torch.equal(draw(0, "pgd:0.031373"), draw(0, "pgd:0.062745"))
    assert rng.cell_hash("pgd:0.031373") < 2**31


def test_config_fingerprint_is_scoped_per_attack(tmp_path):
    parser = build_parser()
    a = parser.parse_args(["--cw_steps", "4"])
    b = parser.parse_args(["--cw_steps", "8", "--attacks", "fgsm", "--resume"])
    assert common.config_fingerprint(a, attack_name="fgsm") == \
        common.config_fingerprint(b, attack_name="fgsm")
    assert common.config_fingerprint(a, attack_name="cw") != \
        common.config_fingerprint(b, attack_name="cw")
    labels = tmp_path / "l.json"
    labels.write_text('{"a.png": 1}')
    c = parser.parse_args(["--labels_json", str(labels)])
    before = common.config_fingerprint(c, attack_name="pgd")
    labels.write_text('{"a.png": 2}')
    assert common.config_fingerprint(c, attack_name="pgd") != before
    assert common.labels_digest(str(labels)) == jax_common.labels_digest(str(labels))


def test_label_helpers_match(tmp_path, capsys):
    labels = tmp_path / "l.json"
    labels.write_text(json.dumps({"a.png": 3, str(tmp_path / "b.png"): 4}))
    paths = [tmp_path / "a.png", tmp_path / "b.png", tmp_path / "c.png"]
    pseudo = np.array([7, 8, 9])
    got = common.resolve_labels(str(labels), paths, pseudo)
    want = jax_common.resolve_labels(str(labels), paths, pseudo)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(common.resolve_labels_sentinel(str(labels), paths),
                                  jax_common.resolve_labels_sentinel(str(labels), paths))
    assert common.resolve_labels_sentinel(None, paths) is None
    assert "WARNING: no label for 1 image(s)" in capsys.readouterr().out
    common.check_label_range([0, 9, common.UNLABELED], 10)
    with pytest.raises(SystemExit, match="out-of-range"):
        common.check_label_range([-2], 10)
    assert common.positive_int("3") == 3
    with pytest.raises(Exception, match="positive"):
        common.positive_int("0")


def test_n_classes_of_reads_the_head():
    b = load_model("resnet_tiny", device="cpu")
    assert common.n_classes_of(b.model) == 10


def test_image_inputs_match(image_dir, tmp_path):
    assert common.resolve_image_inputs(str(image_dir), "x") == \
        jax_common.resolve_image_inputs(str(image_dir), "x")
    single = image_dir / "img_1.jpg"
    assert common.resolve_image_inputs(None, str(single)) == [single]
    for args, match in (((str(tmp_path / "none"), "x"), "image_dir not found"),
                        ((str(tmp_path), "x"), "no images found"),
                        ((None, str(tmp_path / "no.png")), "image not found")):
        with pytest.raises(SystemExit, match=match):
            common.resolve_image_inputs(*args)


@pytest.mark.parametrize("layout", ["subfolders", "val_map", "wnid_annotations"])
def test_list_imagenet_val_matches(tmp_path, layout):
    root = tmp_path / "val"
    if layout == "subfolders":
        val_tree(root)
    else:
        (root / "images").mkdir(parents=True)
        lines = []
        for i in range(4):
            Image.new("RGB", (8, 8)).save(root / "images" / f"v{i}.png")
            label = str(i % 3) if layout == "val_map" else f"n0{i % 2}"
            lines.append(f"v{i}.png {label} 0 0 8 8")
        (root / "val_annotations.txt").write_text("\n".join(lines))
    got = datasets.list_imagenet_val(root)
    want = jax_datasets.list_imagenet_val(root)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def test_phase_timer_matches():
    ours, theirs = PhaseTimer(), jax_profiling.PhaseTimer()
    for t in (ours, theirs):
        with t.phase("a", examples=4):
            pass
        with t.phase("b"):
            pass
    assert ours.as_dict().keys() == theirs.as_dict().keys()
    assert ours.as_dict()["a"].keys() == theirs.as_dict()["a"].keys()
    assert ours.records[0].examples_per_sec > 0 and ours.records[1].examples_per_sec is None


def test_plotted_values():
    stats = {"count": 4, "attack_success": 3, "defense_preproc_success": 1,
             "detector_flags_clean": 1, "detector_flags_adv": 2, "detector_attack_success": 1}
    results = {("pgd", 0.02): stats, ("fgsm", 0.01): {**stats, "attack_success": 2},
               ("pgd", 0.01): stats}
    rows = plots.defense_rates(results)
    assert [(r["Attack"], r["Eps"]) for r in rows] == [("FGSM", 0.01), ("PGD", 0.01),
                                                        ("PGD", 0.02)]
    assert rows[0]["Attack_Success"] == 0.5 and rows[1]["Detector_Clean_Pass"] == 0.75
    eps, attacks, table = plots.pivot(rows, "Bypass_Detection")
    assert eps == [0.01, 0.02] and attacks == ["FGSM", "PGD"]
    np.testing.assert_array_equal(table, [[0.25, 0.25], [np.nan, 0.25]])
    ramp = plots.ramp(np.array([0.0, 1.0]), "Greens")
    assert ramp.tolist() == [[247, 252, 245], [0, 68, 27]]
