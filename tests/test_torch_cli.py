"""The port's classify CLI, image pipeline, labels and import hygiene (CPU)."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.cli import common as jax_common
from image_recognition_adversarial_example_attack_tpu.core import images as jax_images
from image_recognition_adversarial_example_attack_tpu.core import labels as jax_labels
from image_recognition_adversarial_example_attack_tpu_torch.cli import classify, common
from image_recognition_adversarial_example_attack_tpu_torch.core import images, labels

REPO = Path(__file__).resolve().parent.parent
PKG = "image_recognition_adversarial_example_attack_tpu_torch"
EPS = 8 / 255
TOP = re.compile(r"^Top (\d): (\S+) \(class (\d+)\), prob = (0|1)\.\d{4}$")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(50, 70), (64, 48), (40, 40)]):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(d / f"img_{i}.png")
    return d


def _blocks(out: str):
    """Console text -> [(title, [(rank, label, class, prob line)...]), ...]."""
    blocks = []
    for line in out.splitlines():
        if line.endswith(":") and not line.startswith("Top"):
            blocks.append((line[:-1], []))
        elif line.startswith("Top"):
            m = TOP.match(line)
            assert m, line
            blocks[-1][1].append(m.groups())
    return blocks


def test_classify_pgd_on_cpu(image_dir, tmp_path, capsys):
    img = image_dir / "img_0.png"
    adv = tmp_path / "out" / "adv.png"
    rc = classify.main([str(img), "--attack", "pgd", "--device", "cpu",
                        "--model", "resnet_tiny", "--steps", "3", "--save_adv", str(adv)])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == f"Image: {img}"
    blocks = _blocks(out)
    assert [b[0] for b in blocks] == ["Clean", "Adversarial (pgd)"]
    for _, rows in blocks:
        assert [r[0] for r in rows] == ["1", "2", "3", "4", "5"]
        assert all(r[1] == f"class_{r[2]}" for r in rows)  # the label fallback
    saved = np.asarray(Image.open(adv), np.float32) / 255.0
    clean = images.load_image(img)[0]
    assert saved.shape == (224, 224, 3)
    assert np.abs(saved - clean).max() <= EPS + 0.5 / 255 + 1e-6


def test_classify_directory_mode(image_dir, tmp_path, capsys):
    rc = classify.main([str(image_dir), "--attack", "fgsm", "--device", "cpu",
                        "--model", "resnet_tiny", "--topk", "3",
                        "--save_adv", str(tmp_path / "advs")])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("Image: ") == 3 and out.count("Adversarial (fgsm):") == 3
    assert sorted(p.name for p in (tmp_path / "advs").iterdir()) == [
        "adv_img_0.png", "adv_img_1.png", "adv_img_2.png"]


def test_classify_defaults_to_cuda_and_raises_without_it(image_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        classify.main([str(image_dir / "img_0.png"), "--model", "resnet_tiny"])


def test_parser_keeps_the_reference_flags():
    args = classify.build_parser().parse_args(["x.png"])
    assert (args.attack, args.eps, args.alpha, args.steps, args.topk) == (
        "none", EPS, 2 / 255, 10, 5)
    assert args.device == "cuda" and args.model == "resnet50" and args.seed == 0
    assert common.resolve_dtype(None, torch.device("cpu")) == torch.float32
    assert common.resolve_dtype(None, torch.device("cuda")) == torch.bfloat16


def test_seed_flag_leaves_the_weights_alone(monkeypatch, tmp_path):
    """--seed drives the attack's randomness only, as in the JAX CLI, whose
    random init is always PRNGKey(0)."""
    monkeypatch.setenv("ADV_TPU_WEIGHTS_DIR", str(tmp_path))
    parser = classify.build_parser()
    states = []
    for seed in ("0", "1"):
        args = parser.parse_args(["x.png", "--device", "cpu", "--model", "resnet_tiny",
                                  "--seed", seed])
        with pytest.warns(UserWarning, match="random init"):
            states.append(common.load_bundle(args).model.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_print_topk_is_the_jax_format(capsys):
    probs = np.random.RandomState(0).dirichlet(np.ones(12), size=2).astype(np.float32)
    names = [f"n{i}" for i in range(10)]  # fewer names than classes: str(idx)
    outs = []
    for mod in (jax_common, common):
        vals, idx = mod.topk_host(probs, 5)
        mod.print_topk("Clean", vals[1], idx[1], names)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("Clean:\nTop 1: ")


@pytest.mark.parametrize("size", [224, 32])
def test_image_pipeline_matches(image_dir, size):
    for p in sorted(image_dir.iterdir()):
        np.testing.assert_array_equal(images.load_image(p, size=size),
                                      jax_images.load_image(p, size=size))


def test_tolerant_batch_and_save(image_dir, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    paths = [image_dir / "img_1.png", bad, image_dir / "img_2.png"]
    got, good = images.load_image_batch_tolerant(paths, size=32)
    want, want_good = jax_images.load_image_batch_tolerant(paths, size=32)
    np.testing.assert_array_equal(got, want)
    assert good == want_good and len(good) == 2
    x = np.random.RandomState(1).rand(1, 8, 8, 3).astype(np.float32)
    images.save_image_01(x, tmp_path / "a.png")
    jax_images.save_image_01(x, tmp_path / "b.png")
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_labels_search_order_matches(tmp_path, monkeypatch):
    names = tmp_path / "names.txt"
    names.write_text("\n".join(f"name{i}" for i in range(1000)))
    for env in (None, str(names)):
        if env is None:
            monkeypatch.delenv("IMAGENET_CLASSES", raising=False)
        else:
            monkeypatch.setenv("IMAGENET_CLASSES", env)
        labels.load_imagenet_labels.cache_clear()
        jax_labels.load_imagenet_labels.cache_clear()
        assert labels.load_imagenet_labels() == jax_labels.load_imagenet_labels()
    labels.load_imagenet_labels.cache_clear()
    jax_labels.load_imagenet_labels.cache_clear()


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package (whose __init__ imports jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PKG} as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'image_recognition_adversarial_example_attack_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, where CUDA is absent
    or where the port's package is not beside it."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
