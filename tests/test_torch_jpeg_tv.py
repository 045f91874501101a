"""The port's JPEG (host PIL codec and DCT codec) and TV defenses, the
composite ``defend_input`` with each arm, and JPEG/TV cells of
``evaluate_defenses_batch``, against the JAX package (CPU).

The host codec is the same PIL round trip on the same uint8 bytes: bit-exact.
The DCT codec is held in float64, where a straight-through ``round`` cannot
flip at a .5 boundary between the frameworks (1e-12), and in float32 to
1e-5.  The TV solve runs in float32 on both sides with the same op order:
1e-6 after 30 steps, its input gradient 1e-5 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.defenses import jpeg as jax_jpeg
from image_recognition_adversarial_example_attack_tpu.defenses import jpeg_dct as jax_dct
from image_recognition_adversarial_example_attack_tpu.defenses import preprocess as jax_pre
from image_recognition_adversarial_example_attack_tpu.defenses import tv as jax_tv
from image_recognition_adversarial_example_attack_tpu.eval import defense_eval as jax_eval
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
    TV_STEPS, TV_WEIGHT, DefenseConfig, defend_input, jpeg_compress_batch,
    jpeg_dct_roundtrip, jpeg_roundtrip_host, make_features_fn, rof_energy,
    total_variation, tv_minimize)
from image_recognition_adversarial_example_attack_tpu_torch.defenses import jpeg_dct
from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
    STAT_KEYS, DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)

EPS = 8 / 255


def _images(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


@pytest.mark.parametrize("shape", [(3, 17, 23, 3), (1, 32, 32, 3)])
@pytest.mark.parametrize("quality", [75, 30, 95])
def test_host_jpeg_bit_exact(shape, quality):
    x = _images(shape, seed=quality) * 1.2 - 0.1  # values outside [0,1] clip first
    want = jax_jpeg.jpeg_roundtrip_host(x, np.int32(quality))
    got = jpeg_roundtrip_host(x, quality)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    batch = jpeg_compress_batch(torch.from_numpy(x).double(), quality)
    assert batch.dtype == torch.float64
    np.testing.assert_array_equal(batch.numpy(), want.astype(np.float64))


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (1, 21, 13, 3), (2, 16, 40, 3)])
@pytest.mark.parametrize("quality", [75, 20, 50, 100])
def test_dct_jpeg_matches_jax_float64(shape, quality):
    x = _images(shape, seed=shape[1] + quality, dtype=np.float64)
    with jax.enable_x64():
        want = np.asarray(jax_dct.jpeg_dct_roundtrip(jnp.asarray(x), quality=quality))
    got = jpeg_dct_roundtrip(torch.from_numpy(x), quality=quality)
    assert got.shape == x.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


def test_dct_jpeg_matches_jax_float32():
    x = _images((3, 64, 48, 3), seed=9)
    want = np.asarray(jax_dct.jpeg_dct_roundtrip(jnp.asarray(x), quality=75))
    got = jpeg_dct_roundtrip(torch.from_numpy(x), quality=75).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dct_tables_and_matrix_are_the_jax_ones():
    for q in (1, 10, 49, 50, 75, 100, 150):
        for a, b in zip(jpeg_dct._quant_tables(q), jax_dct._quant_tables(q)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpeg_dct._dct_matrix(), jax_dct._dct_matrix())
    d = jpeg_dct._dct_matrix().astype(np.float64)
    np.testing.assert_allclose(d @ d.T, np.eye(8), atol=1e-6)  # orthonormal


def test_up2_is_jax_linear_resize():
    c = np.random.RandomState(1).rand(2, 7, 5)
    with jax.enable_x64():
        want = np.asarray(jax.image.resize(jnp.asarray(c), (2, 14, 10), method="linear"))
    np.testing.assert_allclose(jpeg_dct._up2(torch.from_numpy(c)).numpy(), want,
                               rtol=0, atol=1e-15)


def test_dct_ste_gradient():
    """The rounding passes the gradient straight through, so the codec's
    input gradient is that of its linear chain, the JAX package's own."""
    v = torch.linspace(-3, 3, 13, dtype=torch.float64).requires_grad_(True)
    (g,) = torch.autograd.grad(jpeg_dct._ste_round(v).sum(), v)
    assert torch.equal(g, torch.ones_like(v))
    assert torch.equal(jpeg_dct._ste_round(v), torch.round(v))
    x = _images((2, 24, 40, 3), seed=4, dtype=np.float64) * 0.8 + 0.1
    wv = np.random.RandomState(5).randn(*x.shape)
    with jax.enable_x64():
        want = np.asarray(jax.grad(lambda a: jnp.sum(
            jnp.asarray(wv) * jax_dct.jpeg_dct_roundtrip(a, 75)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (torch.from_numpy(wv) * jpeg_dct_roundtrip(xt, 75)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert np.abs(want).max() > 0.1


def test_dct_jpeg_refuses_a_non_rgb_batch():
    with pytest.raises(ValueError, match=r"\[B,H,W,3\]"):
        jpeg_dct_roundtrip(torch.zeros(1, 16, 16, 1))


@pytest.mark.parametrize("masked", [False, True])
def test_tv_minimize_matches_jax(masked):
    x = _images((2, 20, 30, 3), seed=6)
    mask = (np.random.RandomState(7).rand(2, 20, 30, 1) > 0.5).astype(np.float32) if masked else None
    want = np.asarray(jax_tv.tv_minimize(
        jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask)))
    got = tv_minimize(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the solve lowers the ROF energy it minimizes (against the input itself)
    xt = torch.from_numpy(x)
    mt = None if mask is None else torch.from_numpy(mask)
    e_in = rof_energy(xt, xt, mask=mt)
    e_out = rof_energy(got, xt, mask=mt)
    assert bool((e_out < e_in).all())


def test_tv_value_and_energy_match_jax_float64():
    x, z = (_images((2, 9, 11, 3), seed=s, dtype=np.float64) for s in (8, 9))
    m = (np.random.RandomState(10).rand(2, 9, 11, 1) > 0.3).astype(np.float64)
    with jax.enable_x64():
        want_tv = np.asarray(jax_tv.total_variation(jnp.asarray(x)))
        want_e = np.asarray(jax_tv.rof_energy(jnp.asarray(z), jnp.asarray(x), weight=0.05,
                                              mask=jnp.asarray(m)))
    np.testing.assert_allclose(total_variation(torch.from_numpy(x)).numpy(), want_tv,
                               rtol=1e-13)
    np.testing.assert_allclose(rof_energy(torch.from_numpy(z), torch.from_numpy(x),
                                          weight=0.05, mask=torch.from_numpy(m)).numpy(),
                               want_e, rtol=1e-13)
    assert (TV_WEIGHT, TV_STEPS) == (jax_tv.TV_WEIGHT, jax_tv.TV_STEPS)


def test_tv_nonpositive_weight_is_the_clip():
    x = _images((1, 5, 6, 3), seed=11) * 1.4 - 0.2
    for wgt in (0.0, -1.0):
        got = tv_minimize(torch.from_numpy(x), weight=wgt)
        np.testing.assert_array_equal(got.numpy(), np.clip(x, 0, 1))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_tv.tv_minimize(jnp.asarray(x), weight=wgt)))


def test_tv_gradient_is_finite_on_a_saturated_image():
    """Flat clipped regions make the dual variables exactly zero, where an
    unclamped sqrt has a 0/0 gradient."""
    x = np.clip(_images((2, 20, 30, 3), seed=12) * 3 - 1, 0, 1)
    assert (x == 0).mean() > 0.2 and (x == 1).mean() > 0.2
    wv = np.random.RandomState(13).randn(*x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.asarray(wv) * jax_tv.tv_minimize(a)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((torch.from_numpy(wv) * tv_minimize(xt)).sum(), xt)
    assert bool(torch.isfinite(got).all()) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


ARMS = {
    "jpeg_host": {"use_jpeg": True},
    "jpeg_host_q30": {"use_jpeg": True, "jpeg_quality": 30},
    "jpeg_dct": {"use_jpeg": True, "jpeg_mode": "dct"},
    "tv": {"use_tv": True},
    "tv_jpeg_dct": {"use_tv": True, "tv_weight": 0.1, "tv_steps": 5, "use_jpeg": True,
                    "jpeg_mode": "dct"},
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_defend_input_arms_match_jax(arm):
    """float32 throughout: the host JPEG arm is bit-exact (the chain before the
    codec is, and the codec sees the same bytes); the DCT and TV arms agree
    to 1e-5."""
    x = _images((2, 24, 20, 3), seed=14) * 1.2 - 0.1
    want = np.asarray(jax_pre.defend_input(jnp.asarray(x), jax_pre.DefenseConfig(**ARMS[arm])))
    got = defend_input(torch.from_numpy(x), DefenseConfig(**ARMS[arm])).numpy()
    if arm.startswith("jpeg_host"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_host_jpeg_arm_is_bpda_identity():
    """Exact codec forward, identity backward inside [0,1] (the quantize
    STE's identity composed with the smoothing's linear map)."""
    x = _images((1, 16, 16, 3), seed=15) * 0.8 + 0.1
    wv = np.random.RandomState(16).randn(*x.shape).astype(np.float32)
    cfg = DefenseConfig(use_jpeg=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((torch.from_numpy(wv) * defend_input(xt, cfg)).sum(), xt)
    (plain,) = torch.autograd.grad(
        (torch.from_numpy(wv) * defend_input(xt, DefenseConfig())).sum(), xt)
    assert torch.equal(got, plain)


@pytest.fixture(scope="module")
def cell():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=17)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        lf_jax = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        ff_jax = jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        x = np.random.RandomState(18).uniform(0.05, 0.95, size=(8, 32, 32, 3))
        y = np.asarray(jax.jit(lf_jax)(jnp.asarray(x))).argmax(-1)
        y[::3] = (y[::3] + 1) % 10
        scores = np.sort(np.asarray(jax.jit(lambda xx: jax_det.score_from_features(ff_jax(xx)))(
            jnp.asarray(x))))
    return {"jax": (lf_jax, ff_jax),
            "port": (make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                     make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)),
            "x": x, "y": y, "thr": float((scores[3] + scores[4]) / 2)}


@pytest.mark.parametrize("arm", ["jpeg_host", "jpeg_dct", "tv"])
def test_defense_cell_matches(cell, arm):
    (lf_jax, ff_jax), (lf, ff) = cell["jax"], cell["port"]
    x, y, thr = cell["x"], cell["y"], cell["thr"]
    kw = {"attack_name": "fgsm", "eps": EPS, "alpha": 2 / 255, "steps": 1}
    with jax.enable_x64():
        want = jax.jit(lambda xx, yy, key: jax_eval.evaluate_defenses_batch(
            lf_jax, ff_jax, xx, yy, thr,
            jax_eval.DefenseEvalConfig(**kw, defense=jax_pre.DefenseConfig(**ARMS[arm])),
            key))(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        want_stats = jax_eval.aggregate_stats(want)
    got = evaluate_defenses_batch(
        lf, ff, torch.from_numpy(x), torch.from_numpy(y), thr,
        DefenseEvalConfig(**kw, defense=DefenseConfig(**ARMS[arm])))
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    stats = aggregate_stats(got)
    assert stats == want_stats
    assert 0 < stats["defense_preproc_success"] < 8
    assert summary_line("fgsm", EPS, stats) == jax_eval.summary_line("fgsm", EPS, want_stats)
