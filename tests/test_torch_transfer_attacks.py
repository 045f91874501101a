"""The transfer family in the port (attacks/mifgsm.py, dim.py, tim.py,
through ``run_attack``) against the JAX package's on the CPU.

Both sides attack resnet_tiny with the same float64 weights and float64
logits (the uncast closures of ``_torch_port_helpers``), so no sign()
decision can flip on rounding noise: the adversarial batches agree within
1e-12.  DI-FGSM's randomness is fed JAX's own draws for the same key
(``attacks.dim.draw_diversity``, the one place the port draws them), and
its transform is held to ``jax.image.scale_and_translate``: the float32
weight matrices within 2**-22 relative (a column's normalizing sum adds its
few nonzero weights in another order than XLA, one ulp of the sum apart),
the transformed image within 2 * 2**-22 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import dim as jax_dim
from image_recognition_adversarial_example_attack_tpu.attacks import tim as jax_tim
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    AttackParams, mifgsm_attack, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import dim, tim
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

EPS, ALPHA, STEPS = 8 / 255, 2 / 255, 4
TOL = 1e-12
# a normalizing sum one float32 ulp apart moves a weight by up to 2**-23 of it
SUM_ULP = 2.0**-22
TRANSFORM_TOL = 2 * SUM_ULP  # two such matrices on pixels in [0, 1]


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(11).uniform(0.1, 0.9, size=(3, 32, 32, 3))
        y = np.asarray(fns["jax"][0](jnp.asarray(x))).argmax(-1)
    return fns["jax"][0], fns["port"][0], x, y


def _jax_attack(name, lf, x, y, key, y_target=None, **kw):
    params = jax_api.AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS, **kw)
    with jax.enable_x64():
        return np.asarray(jax.jit(lambda xx: jax_api.run_attack(
            name, lf, xx, jnp.asarray(y), params, key,
            None if y_target is None else jnp.asarray(y_target)))(jnp.asarray(x)))


def _port_attack(name, lf, x, y, y_target=None, generator=None, **kw):
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS, **kw)
    return run_attack(name, lf, torch.from_numpy(x), torch.from_numpy(y), params,
                      generator or generator_from_seed(0),
                      None if y_target is None else torch.from_numpy(y_target)).numpy()


@pytest.mark.parametrize("name", ["mifgsm", "tim"])
@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("mu", [1.0, 0.5])
def test_mifgsm_and_tim_equal_jaxs(setup, name, targeted, mu):
    lf_jax, lf_port, x, y = setup
    y_t = (y + 3) % 10 if targeted else None
    want = _jax_attack(name, lf_jax, x, y, jax.random.PRNGKey(0), y_t, mu=mu)
    got = _port_attack(name, lf_port, x, y, y_t, mu=mu)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(got - x).max() <= EPS + 1e-12 and 0.0 <= got.min() and got.max() <= 1.0
    assert np.abs(got - x).max() > EPS / 2  # the attack moved the batch


def _jax_draws(key, steps, h, w, p, min_scale=0.875):
    """JAX dim_attack's per-step draws for ``key`` (attacks/dim.py: a split
    per step, then diverse_input's four subkeys)."""
    out = []
    with jax.enable_x64():
        for _ in range(steps):
            key, k_div = jax.random.split(key)
            k_apply, k_scale, k_tx, k_ty = jax.random.split(k_div, 4)
            s = jax.random.uniform(k_scale, (), jnp.float32, min_scale, 1.0)
            tx = jax.random.uniform(k_tx, (), jnp.float32, 0.0, 1.0) * (w * (1.0 - s))
            ty = jax.random.uniform(k_ty, (), jnp.float32, 0.0, 1.0) * (h * (1.0 - s))
            apply = jax.random.uniform(k_apply, (), jnp.float32) < p
            out.append(dim.Diversity(bool(apply), float(s), float(tx), float(ty)))
    return out


@pytest.mark.parametrize("p", [0.0, 1.0, 0.5])
def test_dim_equals_jaxs_with_jaxs_draws(setup, p, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key = jax.random.PRNGKey(7)
    draws = iter(_jax_draws(key, STEPS, 32, 32, p))
    monkeypatch.setattr(dim, "draw_diversity", lambda *a, **k: next(draws))
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda xx: jax_dim.dim_attack(
            lf_jax, xx, jnp.asarray(y), eps=EPS, alpha=ALPHA, steps=STEPS, key=key,
            diversity_prob=p))(jnp.asarray(x)))
    got = dim.dim_attack(lf_port, torch.from_numpy(x), torch.from_numpy(y), eps=EPS,
                         alpha=ALPHA, steps=STEPS, generator=generator_from_seed(0),
                         diversity_prob=p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if p == 0.0:  # no transform: MI-FGSM, bit for bit
        mi = mifgsm_attack(lf_port, torch.from_numpy(x), torch.from_numpy(y), eps=EPS,
                           alpha=ALPHA, steps=STEPS).numpy()
        np.testing.assert_array_equal(got, mi)


@pytest.mark.parametrize("s,t", [(0.9, (1.7, 0.6)), (0.875, (0.0, 3.9)), (0.97, (0.5, 0.25)),
                                 (1.0, (0.0, 0.0))])
def test_diverse_input_equals_scale_and_translate(s, t):
    """s < 1 takes scale_and_translate's antialiased (widened) triangle
    kernel; s = 1 with no offset is the identity."""
    s32, ty, tx = np.float32(s), np.float32(t[0]), np.float32(t[1])
    for n, trans in ((32, ty), (24, tx)):
        want = np.asarray(jax_scale.compute_weight_mat(
            n, n, jnp.float32(s32), jnp.float32(trans),
            jax_scale._kernels[jax_scale.ResizeMethod.LINEAR], True))
        got = dim.resample_matrix(n, float(s32), float(trans)).numpy()
        np.testing.assert_allclose(got, want, rtol=SUM_ULP, atol=0)
        assert ((got == 0) == (want == 0)).all()  # the same support
    x = np.random.RandomState(2).rand(2, 32, 24, 3)
    with jax.enable_x64():
        want = np.asarray(jax.vmap(lambda img: jax.image.scale_and_translate(
            img, (32, 24, 3), (0, 1), jnp.array([s32, s32], jnp.float32),
            jnp.array([ty, tx], jnp.float32), method="linear"))(jnp.asarray(x)))
    got = dim.diverse_input(torch.from_numpy(x),
                            dim.Diversity(True, float(s32), float(tx), float(ty))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TRANSFORM_TOL)
    if s == 1.0:
        np.testing.assert_allclose(got, x, rtol=0, atol=TOL)
    xt = torch.from_numpy(x)
    assert dim.diverse_input(xt, dim.Diversity(False, float(s32), 1.0, 1.0)) is xt


def test_draws_are_the_generators():
    """Four uniforms per step from the caller's generator, in JAX's float32
    formulas: s in [0.875, 1), the offsets within the canvas's slack."""
    a = [dim.draw_diversity(generator_from_seed(3), 224, 224) for _ in range(2)]
    assert a[0] == a[1]
    g = generator_from_seed(3)
    d = [dim.draw_diversity(g, 224, 200, p=0.5) for _ in range(50)]
    assert all(0.875 <= v.scale < 1.0 for v in d)
    assert all(0 <= v.tx <= 200 * (1 - v.scale) and 0 <= v.ty <= 224 * (1 - v.scale) for v in d)
    assert 0 < sum(v.apply for v in d) < 50


def test_gaussian_kernel_and_smoothing_equal_jaxs():
    np.testing.assert_array_equal(tim.gaussian_kernel(7), jax_tim.gaussian_kernel(7))
    np.testing.assert_array_equal(tim.gaussian_kernel(5, 1.3), jax_tim.gaussian_kernel(5, 1.3))
    with pytest.raises(ValueError, match="odd"):
        tim.gaussian_kernel(4)
    g = np.random.RandomState(4).randn(2, 16, 12, 3)
    with jax.enable_x64():
        want = np.asarray(jax_tim.smooth_gradient(jnp.asarray(g), jax_tim.gaussian_kernel(7)))
    got = tim.smooth_gradient(torch.from_numpy(g), tim.gaussian_kernel(7))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_params_and_registry_match_jaxs():
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import ATTACK_THREAT

    assert AttackParams().mu == jax_api.AttackParams().mu == 1.0
    for name, threat in ATTACK_THREAT.items():
        assert jax_api.ATTACK_THREAT[name] == threat


# ---------------------------------------------------------------------------
# the CLIs take the three; every other JAX choice is refused before any
# device work
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--steps", "2"]


@pytest.fixture(scope="module")
def cli_images(tmp_path_factory):
    from _torch_cli_helpers import write_images

    return write_images(tmp_path_factory.mktemp("imgs"), n=2, size=40)


def test_classify_runs_the_transfer_family(cli_images, capsys):
    from image_recognition_adversarial_example_attack_tpu_torch.cli import classify

    for name in ("mifgsm", "dim", "tim"):
        assert classify.main([str(cli_images / "img_0.jpg"), "--attack", name, "--model",
                              "resnet_tiny", *SMALL]) == 0
        assert f"Adversarial ({name}):" in capsys.readouterr().out


def test_grid_and_transfer_clis_run_the_transfer_family(cli_images, tmp_path, capsys):
    import json
    import re

    from image_recognition_adversarial_example_attack_tpu_torch.cli import (
        blackbox_transfer, defense_experiments, transferability)

    three = ["mifgsm", "dim", "tim"]
    assert defense_experiments.main([
        "--image_dir", str(cli_images), "--attacks", *three, "--eps_list", "0.03137",
        "--viz_samples", "0", "--model", "resnet_tiny", "--output_dir", str(tmp_path / "grid"),
        *SMALL]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("attack=")]
    summary = re.compile(r"^attack=(\w+), eps=0\.03137, attack_success=\d\.\d{3}, "
                         r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
                         r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")
    assert sorted(summary.match(ln)[1] for ln in lines) == sorted(three)
    assert transferability.main([
        "--image_dir", str(cli_images), "--source_model", "resnet_tiny", "--target_models",
        "tiny", "--attacks", *three, "--eps_list", "0.03", "--convention", "blackbox",
        "--output_dir", str(tmp_path / "tr"), *SMALL]) == 0
    results = json.loads((tmp_path / "tr" / "transfer_results.json").read_text())
    assert all(a in json.dumps(results) for a in three)
    assert blackbox_transfer.main([
        "--image_dir", str(cli_images), "--source", "resnet_tiny", "--targets", "tiny",
        "--attacks", "mifgsm", "--visualize_n", "0", *SMALL]) == 0
    assert "MIFGSM" in capsys.readouterr().out.upper()


@pytest.mark.parametrize("cli", ["classify", "grid", "blackbox", "transferability"])
def test_every_jax_attack_choice_reaches_the_device(cli, cli_images, capsys):
    """Asked for the card (absent here), every attack choice of the JAX CLIs
    gets past the arguments to the device rule (nothing refuses an attack
    before it); on the CPU classify runs a black-box one."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli import (
        blackbox_transfer, classify, defense_experiments, transferability)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import (
        ATTACK_CHOICES, CLASSIFY_ATTACK_CHOICES)

    cuda = ["--device", "cuda"]
    if cli == "classify":
        for name in CLASSIFY_ATTACK_CHOICES[1:]:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                classify.main([str(cli_images / "img_0.jpg"), "--attack", name, *cuda])
        assert classify.main([str(cli_images / "img_0.jpg"), "--attack", "square",
                              "--square_steps", "3", "--model", "resnet_tiny", *SMALL]) == 0
        assert "square" in capsys.readouterr().out.lower()
        return
    main = {"grid": defense_experiments.main, "blackbox": blackbox_transfer.main,
            "transferability": transferability.main}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--image_dir", str(cli_images), "--attacks", *ATTACK_CHOICES, *cuda])
