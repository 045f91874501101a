"""The uap and certify CLIs of the port (cli/uap.py, cli/certify.py) and the
grid's ``--certified`` (cli/defense_experiments.py) against the JAX
package's on the CPU.

Both packages load the same ibp_tiny weights from one Flax msgpack file
(32x32 inputs, so the CLIs run in seconds) and read the same three 48x48
PNGs.  Where a
run draws (the patch's placements, the smoothing noise) the JAX CLI's key
chain is replayed and its draws fed to the port through
``patch.sample_placements`` and ``smoothing.draw_noise``; then the JSON
files have the same keys and the same values: integers, classes and flags
exactly, radii exactly (the same votes give the same scipy statistics),
float32 losses, patches and margins within ``TOL`` relative.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
from flax import serialization
from PIL import Image

from _torch_blackbox_helpers import feed, t
from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import patch as jax_patch
from image_recognition_adversarial_example_attack_tpu.cli import certify as jax_certify_cli
from image_recognition_adversarial_example_attack_tpu.cli import uap as jax_uap_cli
from image_recognition_adversarial_example_attack_tpu.models import ibp as jax_models
from image_recognition_adversarial_example_attack_tpu_torch.attacks import patch
from image_recognition_adversarial_example_attack_tpu_torch.cli import certify, common, uap
from image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments import (
    main as grid_main)
from image_recognition_adversarial_example_attack_tpu_torch.defenses import smoothing

TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("certify_cli")
    images = root / "imgs"
    images.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray((rs.rand(48, 48, 3) * 255).astype(np.uint8)).save(images / f"im_{i}.png")
    module = jax_models.ibp_tiny()
    v = jax.device_get(module.init(jax.random.PRNGKey(2), np.zeros((1, 32, 32, 3), np.float32)))
    v = {"params": {k: {kk: np.asarray(vv) + (0.05 * rs.randn(*vv.shape)).astype(np.float32)
                        for kk, vv in d.items()} for k, d in v["params"].items()}}
    tiny = root / "ibp_tiny.msgpack"
    tiny.write_bytes(serialization.to_bytes(v))
    return {"root": root, "images": images, "params": v["params"], "module": module,
            "ibp": ["--image_dir", str(images), "--model", "ibp_tiny", "--weights", str(tiny)],
            # a model without a spec (random init)
            "resnet": ["--image_dir", str(images), "--model", "resnet_tiny"]}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _close(a, b, path=""):
    """Equal JSON trees: same keys; floats within TOL relative, the rest equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _close(u, v, f"{path}/{i}")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("ours,theirs", [(uap, jax_uap_cli), (certify, jax_certify_cli)])
def test_parser_keeps_the_jax_flags(ours, theirs):
    o = {a.dest: (a.default, a.choices) for a in ours.build_parser()._actions}
    w = {a.dest: (a.default, a.choices) for a in theirs.build_parser()._actions}
    assert set(o) - set(w) == {"device"} and set(w) - set(o) == set()
    assert {k for k in w if o[k] != w[k]} == set()


def _jsons(setup, name, main_ours, main_theirs, argv, ours_extra=()):
    out = {}
    for who, main, extra in (("ours", main_ours, ["--device", "cpu", *ours_extra]),
                             ("theirs", main_theirs, [])):
        path = setup["root"] / f"{name}_{who}"
        _run(main, [*argv, "--output", str(path), *extra])
        out[who] = path
    return out


def test_uap_json_is_the_jax_clis(setup):
    out = _jsons(setup, "uap", uap.main, jax_uap_cli.main,
                 [*setup["ibp"], "--epochs", "3", "--eps", "0.03"])
    data = {k: json.loads(p.with_suffix(".json").read_text()) for k, p in out.items()}
    _close(data["ours"], data["theirs"])
    np.testing.assert_allclose(np.load(out["ours"].with_suffix(".npy")),
                               np.load(out["theirs"].with_suffix(".npy")), rtol=0, atol=TOL)
    with Image.open(out["ours"].with_suffix(".png")) as im:
        assert im.size == (32, 32)


def test_patch_json_is_the_jax_clis_on_its_draws(setup, monkeypatch):
    """The placements of the 4 training steps, then of the evaluation
    (``fold_in(key, 1)``) and of the saved images (``fold_in(key, 2)``)."""
    steps, size, target = 4, 12, 3
    key = jax.random.PRNGKey(0)
    keys = [*jax.random.split(key, steps), jax.random.fold_in(key, 1), jax.random.fold_in(key, 2)]
    draws = [tuple(t(v) for v in jax_patch.sample_placements(k, 3, (32, 32), size))
             for k in keys]
    monkeypatch.setattr(patch, "sample_placements", feed(draws))
    adv = setup["root"] / "patch_adv"
    out = _jsons(setup, "patch", uap.main, jax_uap_cli.main,
                 [*setup["ibp"], "--mode", "patch", "--steps", str(steps), "--patch_size",
                  str(size), "--target", str(target), "--lr", "0.05"],
                 ours_extra=["--save_adv_dir", str(adv)])
    data = {k: json.loads(p.with_suffix(".json").read_text()) for k, p in out.items()}
    assert "targeted_success_rate" in data["ours"]
    _close(data["ours"], data["theirs"])
    np.testing.assert_allclose(np.load(out["ours"].with_suffix(".npy")),
                               np.load(out["theirs"].with_suffix(".npy")), rtol=0, atol=TOL)
    assert sorted(p.name for p in adv.iterdir()) == ["im_0_adv.png", "im_1_adv.png",
                                                    "im_2_adv.png"]


def _smoothing_noise(seed, n_sigmas, b, mb, n0, n, chunk, shape):
    """The JAX CLI's noise: per sigma ``fold_in(key, si)``, split into the
    selection and estimation keys, ``fold_in`` per slice, ``split`` per chunk."""
    key = jax.random.PRNGKey(seed)
    out = []
    for si in range(n_sigmas):
        k0, k1 = jax.random.split(jax.random.fold_in(key, si))
        for k, m in ((k0, n0), (k1, n)):
            for i in range(0, b, mb):
                for kc in jax.random.split(jax.random.fold_in(k, i), -(-m // chunk)):
                    out.append(t(jax.random.normal(kc, (chunk, mb) + shape)))
    return out


def test_certify_smoothing_json_is_the_jax_clis_on_its_noise(setup, monkeypatch):
    args = ["--n0", "8", "--n", "16", "--chunk", "4", "--max_batch", "2",
            "--sigmas", "0.12", "0.25", "--alpha", "0.05"]
    monkeypatch.setattr(smoothing, "draw_noise",
                        feed(_smoothing_noise(0, 2, 3, 2, 8, 16, 4, (32, 32, 3))))
    plot = setup["root"] / "cert.png"
    out = _jsons(setup, "cert.json", certify.main, jax_certify_cli.main,
                 [*setup["ibp"], *args], ours_extra=["--plot", str(plot)])
    data = {k: json.loads(p.read_text()) for k, p in out.items()}
    assert set(data["ours"]) == {"n0", "n", "alpha", "sweeps"}
    _close(data["ours"], data["theirs"])
    radii = [r["certified_radius"] for s in data["ours"]["sweeps"] for r in s["results"]]
    assert any(r > 0 for r in radii)
    with Image.open(plot) as im:
        assert im.mode == "RGB" and im.size[0] > 500


@pytest.mark.parametrize("method", ["ibp", "crown-ibp"])
def test_certify_bounds_json_is_the_jax_clis(setup, method):
    argv = [*setup["ibp"], "--method", method, "--eps_list", "0.0005", "0.004"]
    out = _jsons(setup, f"{method}.json", certify.main, jax_certify_cli.main, argv)
    data = {k: json.loads(p.read_text()) for k, p in out.items()}
    assert set(data["ours"]) == {"method", "model", "sweeps"}
    _close(data["ours"], data["theirs"])


def test_certify_refuses_a_model_without_a_spec(setup):
    with pytest.raises(SystemExit, match="needs a spec-driven model"):
        certify.main([*setup["resnet"], "--method", "crown-ibp", "--device", "cpu"])


def _grid(setup, out, *extra):
    return _run(grid_main, [*setup["ibp"], "--device", "cpu", "--attacks", "fgsm", "pgd",
                            "--steps", "2", "--eps_list", "0.0005", "0.004", "--viz_samples",
                            "0", "--output_dir", str(out), *extra])


def test_grid_certified_rows_resident_and_streamed(setup):
    """The rows equal the JAX verify function on the same images and pseudo-
    labels; streamed in chunks of two they are the same; --certified is not
    in the resume fingerprint."""
    rows = {}
    for name, mb in (("one", "0"), ("stream", "2")):
        out = setup["root"] / f"grid_{name}"
        text = _grid(setup, out, "--certified", "crown-ibp", "--max_batch", mb)
        assert "certified(crown-ibp), eps=0.00050: verified_acc=" in text
        data = json.loads((out / "certified_accuracy.json").read_text())
        assert data["method"] == "crown-ibp" and data["model"] == "ibp_tiny"
        rows[name] = data["rows"]
    assert rows["one"] == rows["stream"]

    from image_recognition_adversarial_example_attack_tpu.core.images import load_image_batch
    from image_recognition_adversarial_example_attack_tpu.defenses import crown_ibp as jax_crown

    paths = sorted(setup["images"].glob("*.png"))
    x = load_image_batch(paths, size=32)
    y = np.asarray(setup["module"].apply({"params": setup["params"]}, x)).argmax(-1)
    mean, std = np.zeros(3, np.float32), np.ones(3, np.float32)
    for row in rows["one"]:
        out = jax.jit(jax_crown.make_crown_verify_fn(setup["params"], setup["module"].spec,
                                                     mean, std))(x, y, row["eps"])
        assert row["count"] == 3
        assert row["verified_accuracy"] == float(np.mean(np.asarray(out["verified"])))
        assert row["clean_accuracy"] == float(np.mean(np.asarray(out["correct"]))) == 1.0
    assert rows["one"][0]["verified_accuracy"] > 0

    # another --certified resumes every cell of the run above
    resumed = _grid(setup, setup["root"] / "grid_one", "--certified", "ibp", "--max_batch",
                    "0", "--resume")
    assert resumed.count("(resumed from partial results)") == 4
    assert "certified(ibp), eps=0.00400:" in resumed


def test_grid_certified_fails_fast_on_a_model_without_a_spec(setup):
    with pytest.raises(SystemExit, match="needs a spec-driven model"):
        _run(grid_main, [*setup["resnet"], "--device", "cpu", "--attacks", "fgsm",
                         "--certified", "ibp", "--viz_samples", "0",
                         "--output_dir", str(setup["root"] / "nospec")])
    assert not (setup["root"] / "nospec").exists()


def test_model_input_size_and_bmp_inputs(tmp_path):
    import argparse

    assert common.model_input_size(argparse.Namespace(model="ibp_cnn7")) == 32
    assert common.model_input_size(argparse.Namespace(model="resnet50")) == 224
    for name in ("a.bmp", "b.png"):
        Image.new("RGB", (8, 8)).save(tmp_path / name)
    args = argparse.Namespace(image_dir=str(tmp_path), image="x", imagenet_val_dir=None)
    assert [p.name for p in common.resolve_eval_inputs(args)] == ["b.png"]
    assert [p.name for p in common.resolve_eval_inputs(args, skip_bmp=False)] == [
        "a.bmp", "b.png"]
