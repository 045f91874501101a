"""The port's trajectories (eval/trajectory.py), the visualize CLI's figures
(viz/plots.py) and the CLI itself (cli/visualize.py, with ``--gradcam`` and
``--landscape``) against the JAX package on the CPU.

The trajectories run resnet_tiny on bridged float64 weights with float64
logits on both sides, so no sign() of the gradient can flip: probabilities
and L2 agree within 1e-9, the final iterate within 1e-12."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.eval import trajectory as jax_traj
from image_recognition_adversarial_example_attack_tpu_torch.eval import trajectory
from image_recognition_adversarial_example_attack_tpu_torch.viz import plots

EPS, ALPHA = 8 / 255, 2 / 255


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=6)
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    fns = uncast_fns(module, variables, model)
    x = np.random.RandomState(2).uniform(0.05, 0.95, (2, 32, 32, 3))
    with jax.enable_x64():
        y = np.asarray(fns["jax"][0](jnp.asarray(x))).argmax(-1)
    return {"jax": fns["jax"][0], "port": fns["port"][0], "x": x, "y": y}


def _compare(ours, theirs):
    np.testing.assert_allclose(ours.probs.numpy(), np.asarray(theirs.probs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.l2.numpy(), np.asarray(theirs.l2), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.x_adv.numpy(), np.asarray(theirs.x_adv), rtol=0, atol=1e-12)


@pytest.mark.parametrize("track", [(), (3, -1, 12)])
def test_pgd_trajectory_matches_jax(pair, track):
    """No random start: the whole run is deterministic.  ``()`` tracks
    (y_true[0], 805); resnet_tiny has 10 classes, so 805 reads class 9 on
    both sides, as do -1 and 12 in the explicit list."""
    with jax.enable_x64():
        theirs = jax_traj.pgd_trajectory(pair["jax"], jnp.asarray(pair["x"]),
                                         jnp.asarray(pair["y"]), eps=EPS, alpha=ALPHA, steps=4,
                                         key=jax.random.PRNGKey(0), track_classes=track,
                                         random_start=False)
    ours = trajectory.pgd_trajectory(pair["port"], torch.from_numpy(pair["x"]),
                                     torch.from_numpy(pair["y"]), eps=EPS, alpha=ALPHA, steps=4,
                                     generator=torch.Generator(), track_classes=track,
                                     random_start=False)
    assert ours.probs.shape == (5, len(track) or 2) and ours.l2.shape == (5,)
    _compare(ours, theirs)
    with torch.no_grad():
        p = torch.softmax(pair["port"](ours.x_adv), -1)[0]
    assert float(ours.probs[-1, -1]) == float(p[9])  # the clamped class
    assert float(ours.l2[0]) == 0.0 and bool((ours.l2[1:] > 0).all())


def test_fgsm_trajectory_matches_jax(pair):
    with jax.enable_x64():
        theirs = jax_traj.fgsm_trajectory(pair["jax"], jnp.asarray(pair["x"]),
                                          jnp.asarray(pair["y"]), eps=EPS)
    ours = trajectory.fgsm_trajectory(pair["port"], torch.from_numpy(pair["x"]),
                                      torch.from_numpy(pair["y"]), eps=EPS)
    assert ours.probs.shape == (2, 2)
    _compare(ours, theirs)


def test_random_start_stays_in_the_ball(pair):
    g = torch.Generator().manual_seed(5)
    ours = trajectory.pgd_trajectory(pair["port"], torch.from_numpy(pair["x"]),
                                     torch.from_numpy(pair["y"]), eps=EPS, alpha=ALPHA, steps=3,
                                     generator=g)
    x = torch.from_numpy(pair["x"])
    assert float((ours.x_adv - x).abs().max()) <= EPS + 1e-12
    assert ours.probs.shape == (4, 2) and float(ours.l2[0]) > 0.0


def test_figure_values():
    """The plotted values are the JAX figures' formulas: the 50-bin
    histogram on [-0.1, 0.1], the log1p of the shifted channel-mean
    spectrum, and the x10 / x50 amplified images."""
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (16, 12, 3)).astype(np.float32)
    x_adv = np.clip(x + rs.uniform(-0.05, 0.05, x.shape), 0, 1).astype(np.float32)
    diff = x_adv - x
    counts, edges = plots.perturbation_histogram(diff)
    want_counts, want_edges = np.histogram(diff.flatten(), bins=50, range=(-0.1, 0.1))
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(edges, want_edges)
    np.testing.assert_array_equal(plots.perturbation_spectrum(diff),
                                  np.log1p(np.abs(np.fft.fftshift(np.fft.fft2(diff.mean(axis=2))))))
    assert plots.AMPLIFICATIONS == (10, 50)
    np.testing.assert_array_equal(plots.amplified(x, x_adv, 10), np.clip(x + 10 * diff, 0, 1))


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz")
    img = root / "cat.png"
    Image.fromarray((np.random.RandomState(3).rand(80, 96, 3) * 255).astype(np.uint8)).save(img)
    _, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, size=224, seed=8)
    weights = root / "resnet_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(variables))
    args = ["--image", str(img), "--model", "resnet_tiny", "--weights", str(weights),
            "--steps", "3", "--cw_steps", "4", "--cw_c", "5"]
    return {"root": root, "args": args}


def _key_tree(d):
    return {k: _key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


def test_visualize_cli_writes_the_jax_report(cli_inputs, capsys):
    from image_recognition_adversarial_example_attack_tpu.cli import visualize as jax_cli
    from image_recognition_adversarial_example_attack_tpu_torch.cli import visualize

    ours_dir, theirs_dir = cli_inputs["root"] / "ours", cli_inputs["root"] / "theirs"
    assert visualize.main([*cli_inputs["args"], "--device", "cpu", "--save_images",
                           "--output_dir", str(ours_dir)]) == 0
    out = capsys.readouterr().out
    assert "Quantitative metrics:" in out and "L∞ (pixel)......" in out
    assert jax_cli.main([*cli_inputs["args"], "--output_dir", str(theirs_dir)]) == 0
    for name in ("attack_comparison.png", "attack_trajectory.png", "perturbation_analysis.png"):
        with Image.open(ours_dir / name) as im:
            assert im.format == "PNG" and im.width > 500, name
    for attack in ("fgsm", "pgd", "cw"):
        assert (ours_dir / "adversarial_images" / f"adv_{attack}.png").is_file()
    ours = json.loads((ours_dir / "attack_report.json").read_text())
    theirs = json.loads((theirs_dir / "attack_report.json").read_text())
    assert _key_tree(ours) == _key_tree(theirs)
    assert ours["params"] == theirs["params"]
    assert ours["clean_prediction"]["class_id"] == theirs["clean_prediction"]["class_id"]
    # fgsm and cw are deterministic; pgd's random start has other bits in
    # each package
    for attack in ("fgsm", "cw"):
        assert (ours["attacks"][attack]["predicted_class"]
                == theirs["attacks"][attack]["predicted_class"]), attack
    for attack in ("fgsm", "pgd"):
        m = ours["attacks"][attack]["metrics"]
        assert m["L∞ (pixel)"] <= ours["params"]["eps"] + 1e-6
        assert 0.0 <= m["SSIM"] <= 1.0 and np.isfinite(m["PSNR"])


@pytest.mark.parametrize("flag", ["--gradcam", "--landscape"])
def test_unported_flags_exit_before_device_work(flag, cli_inputs, monkeypatch):
    """The two flags were refused before any device work until Grad-CAM and
    the landscape were ported; now each is accepted and the run goes on to
    the device."""
    cli = "image_recognition_adversarial_example_attack_tpu_torch.cli.visualize"

    class ReachedTheDevice(Exception):
        pass

    def reached(*a):
        raise ReachedTheDevice

    monkeypatch.setattr(f"{cli}.resolve_device", reached)
    from image_recognition_adversarial_example_attack_tpu_torch.cli import visualize

    with pytest.raises(ReachedTheDevice):
        visualize.main([*cli_inputs["args"], flag])


def test_parser_keeps_the_jax_flags():
    from image_recognition_adversarial_example_attack_tpu.cli import visualize as jax_cli
    from image_recognition_adversarial_example_attack_tpu_torch.cli import visualize

    ours = {a.dest: a.default for a in visualize.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) - set(ours) == set()
    assert {k for k in ours if k in theirs and ours[k] != theirs[k]} == set()


def test_gradcam_and_landscape_write_the_jax_report(cli_inputs, capsys):
    """``--gradcam --landscape``: the two extra figures, and the report's
    attacks carry the JAX CLI's one extra key, ``gradcam_iou`` (JAX
    cli/visualize.py:256-257; the rest of the layout is held to the JAX
    CLI's by test_visualize_cli_writes_the_jax_report)."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli import visualize

    extra = ["--gradcam", "--landscape", "--landscape_grid", "3"]
    ours_dir = cli_inputs["root"] / "ours_gc"
    assert visualize.main([*cli_inputs["args"], *extra, "--device", "cpu",
                           "--output_dir", str(ours_dir)]) == 0
    out = capsys.readouterr().out
    for name in ("gradcam_attack.png", "loss_landscape.png"):
        assert f"saved: {ours_dir / name}" in out
        with Image.open(ours_dir / name) as im:
            assert im.format == "PNG" and im.width > 1000, name
    ours = json.loads((ours_dir / "attack_report.json").read_text())
    assert list(ours["attacks"]) == ["fgsm", "pgd", "cw"]
    for attack, r in ours["attacks"].items():
        assert set(r) == {"predicted_class", "predicted_name", "confidence", "success",
                          "metrics", "gradcam_iou"}, attack
        assert 0.0 <= r["gradcam_iou"] <= 1.0


def test_gradcam_is_skipped_on_a_model_without_the_conv_tap(tmp_path, capsys):
    from image_recognition_adversarial_example_attack_tpu_torch.cli import visualize

    img = tmp_path / "img.png"
    Image.fromarray((np.random.RandomState(1).rand(40, 40, 3) * 255).astype(np.uint8)).save(img)
    assert visualize.main(["--image", str(img), "--model", "tiny", "--device", "cpu",
                           "--steps", "1", "--cw_steps", "1", "--gradcam",
                           "--output_dir", str(tmp_path / "out")]) == 0
    assert "gradcam skipped: TinyCNN exposes no features_last/head_from_features split" \
        in capsys.readouterr().out
    report = json.loads((tmp_path / "out" / "attack_report.json").read_text())
    assert all("gradcam_iou" not in r for r in report["attacks"].values())
    assert not (tmp_path / "out" / "gradcam_attack.png").exists()


def test_landscape_and_gradcam_figures(tmp_path):
    """The overlay's blend, the landscape's bands, and the two files."""
    cam = np.linspace(0, 1, 16).reshape(4, 4)
    img = np.full((4, 4, 3), 0.5)
    over = plots.cam_overlay(img, cam)
    want = np.round(127.5 * (1 - plots.CAM_ALPHA)
                    + plots.ramp(cam, "magma").astype(np.float64) * plots.CAM_ALPHA)
    np.testing.assert_array_equal(over, want.astype(np.uint8))
    np.testing.assert_array_equal(plots.cam_overlay(None, cam), plots.ramp(cam, "magma"))
    grid = np.arange(25, dtype=np.float64).reshape(5, 5)
    bands = plots.landscape_bands(grid)
    assert bands.min() == 0.0 and bands.max() == 1.0 and np.all(np.diff(bands.ravel()) >= 0)
    np.testing.assert_array_equal(plots.landscape_bands(np.ones((3, 3))), 0.0)
    plots.plot_loss_landscape({"fgsm": grid, "pgd": grid.T}, 1.5, tmp_path / "ll.png")
    plots.plot_gradcam_panel(img, {"pgd": {"x_adv": img, "cam_clean": cam, "cam_adv": cam.T,
                                           "pred_clean": (1, "a", 0.5),
                                           "pred_adv": (2, "b", 0.4), "cam_iou": 0.25}},
                             tmp_path / "gc.png")
    for name in ("ll.png", "gc.png"):
        with Image.open(tmp_path / name) as im:
            assert im.format == "PNG" and im.width > 500
