"""The port's common-corruption bank (eval/corruptions.py),
``stream_correctness_cell``, the tensor-quality JPEG tables, the corruption
heatmap and the corruption_eval CLI against the JAX package's on the CPU.

- ``map_coordinates`` against ``jax.scipy.ndimage.map_coordinates`` in
  float64 within 1e-12, orders 0 and 1, with coordinates outside the image,
  negative ones and exact .5 ties (order 0 rounds them away from zero);
- each of the 17 corruptions at severities 1-5 against the JAX registry's
  function (one jit per corruption, the severity row traced), JAX's draws
  for the key fed through the port's arithmetic (``apply_corruption(...,
  draws=...)``): within ``TOL``, on an RGB batch and, where JAX allows it,
  a grayscale one;
- the registry, ``severity_row``'s clamping, ``apply_corruption``'s errors,
  ``make_corruption_run``, the tensor-quality tables for every quality
  1..100, ``stream_correctness_cell``;
- the CLI on one msgpack of ibp_tiny weights (32x32 PNGs): the deterministic
  cells' accuracies and the JSON keys equal to the JAX CLI's; a cell's
  randomness independent of the other corruptions run; resident and
  streamed equal; the heatmap written.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.scipy.ndimage import map_coordinates as jax_map_coordinates
from PIL import Image

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.cli import corruption_eval as jax_cli
from image_recognition_adversarial_example_attack_tpu.defenses import jpeg_dct as jax_jpeg
from image_recognition_adversarial_example_attack_tpu.eval import corruptions as jax_c
from image_recognition_adversarial_example_attack_tpu.models import ibp as jax_ibp
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.cli import corruption_eval as cli
from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
    cell_generator, chunk_generator, generator_from_seed)
from image_recognition_adversarial_example_attack_tpu_torch.defenses import jpeg_dct
from image_recognition_adversarial_example_attack_tpu_torch.eval import corruptions as c
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
    make_placer, stream_correctness_cell)
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

TOL = 1e-5  # float32 corruptions, absolute (outputs in [0,1])


def _x(channels: int = 3) -> np.ndarray:
    """A smooth gradient plus low noise, [2,16,16,C] (the JAX package's own
    test batch): the blurs change it at every severity."""
    rs = np.random.RandomState(3)
    rr, cc = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16), indexing="ij")
    base = np.stack([rr, cc, 0.5 * (rr + cc)], -1)[None]
    x = np.clip(0.8 * base + 0.1 + 0.05 * rs.rand(2, 16, 16, 3), 0, 1).astype(np.float32)
    return x if channels == 3 else x[..., :1].copy()


def _jax_draws(name: str, x, row, key) -> tuple:
    """The draws the JAX registry's function makes from ``key``, in the
    layout of the port's draw function."""
    b, h, w = x.shape[:3]
    r = jax.random
    if name in ("gaussian_noise", "speckle_noise"):
        return (r.normal(key, x.shape, x.dtype),)
    if name == "shot_noise":
        return (r.poisson(key, x * row[0]),)
    if name == "impulse_noise":
        return (r.uniform(key, x.shape, x.dtype),)
    if name == "motion_blur":
        return (r.uniform(key, (b,), minval=-jnp.pi / 4, maxval=jnp.pi / 4),)
    if name == "glass_blur":
        out = []
        for i in range(2):
            k1, k2, key = r.split(r.fold_in(key, i), 3)
            out += [r.uniform(k, (b, h, w), minval=-row[1], maxval=row[1]) for k in (k1, k2)]
        return tuple(out)
    if name == "snow":
        k_layer, k_angle = r.split(key)
        return (r.normal(k_layer, (b, h, w, 1), x.dtype),
                r.uniform(k_angle, (b,), minval=-3 * jnp.pi / 4, maxval=-jnp.pi / 4))
    if name == "fog":
        n_oct = max(1, int(np.log2(max(min(h, w) // 4, 1))) + 1)
        return tuple(r.uniform(r.fold_in(key, o), (b, 4 * 2 ** o, 4 * 2 ** o), x.dtype)
                     for o in range(n_oct))
    if name == "elastic_transform":
        return (r.uniform(key, (b, h, w, 2), x.dtype, -1.0, 1.0),)
    return ()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# map_coordinates

def _coords(shape, rs):
    """Coordinates over [-3, n+2] on a 0.25 grid (exact .5 ties, negative
    ones, ones past the edge) and random ones."""
    grid = np.arange(-3.0, 16.0 + 2.0, 0.25)
    v = rs.choice(grid, shape)
    v[..., ::3] = rs.uniform(-3.0, 18.0, v[..., ::3].shape)
    return v


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("per_image", [False, True], ids=["shared", "per_image"])
def test_map_coordinates_equals_jaxs_in_float64(order, per_image):
    rs = np.random.RandomState(order + 2 * per_image)
    x = rs.rand(2, 16, 12, 3)
    shape = (2, 9, 7) if per_image else (9, 7)
    rr, cc = _coords(shape, rs) * (16 / 19), _coords(shape, rs) * (12 / 19)
    # ties: away from zero (torch.round would take 0, 2, 14, -0 and 0, 4, 10, -2)
    rr.flat[:4] = [-0.5, 0.5, 2.5, 14.5]
    cc.flat[:4] = [0.5, 4.5, 10.5, -2.5]
    got = c.map_coordinates(_t(x), _t(rr), _t(cc), order=order).numpy()
    with jax.enable_x64():
        want = np.zeros(got.shape)
        for i in range(2):
            r2, c2 = (rr[i], cc[i]) if per_image else (rr, cc)
            for ch in range(3):
                want[i, ..., ch] = jax_map_coordinates(jnp.asarray(x[i, ..., ch]),
                                                       [jnp.asarray(r2), jnp.asarray(c2)],
                                                       order=order, mode="nearest")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_round_half_away_from_zero_is_lax_round():
    v = np.array([-2.5, -1.5, -0.5, -0.49999997, 0.0, 0.49999997, 0.5, 1.5, 2.5, 3.4999998,
                  -7.0, 1e7 + 1.0], np.float32)
    got = c._round_half_away_from_zero(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.lax.round(jnp.asarray(v))))
    assert got[2] == -1.0 and got[6] == 1.0 and got[8] == 3.0


# ---------------------------------------------------------------------------
# the bank against the JAX registry on JAX's draws

CASES = [(n, 3) for n in jax_c.CORRUPTION_NAMES] + [
    (n, 1) for n in jax_c.CORRUPTION_NAMES if n != "jpeg_compression"]


@pytest.mark.parametrize("name,channels", CASES, ids=[f"{n}-c{ch}" for n, ch in CASES])
def test_corruption_equals_jaxs_on_its_draws(name, channels):
    x = _x(channels)
    fn = jax_c._REGISTRY[name][0]
    both = jax.jit(lambda xx, row, key: (fn(xx, row, key), _jax_draws(name, xx, row, key)))
    for sev in range(1, 6):
        key = jax.random.fold_in(jax.random.PRNGKey(7), sev)
        want, draws = both(jnp.asarray(x), jax_c.severity_row(name, sev), key)
        want, draws = np.asarray(want), tuple(_t(d).float() for d in draws)
        # the port's draw function makes draws of JAX's layout
        ours = c.draw_corruption(name, torch.from_numpy(x), sev, generator_from_seed(0))
        assert [d.shape for d in ours] == [d.shape for d in draws]
        got = c.apply_corruption(name, torch.from_numpy(x), sev, draws=draws)
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL, err_msg=f"severity {sev}")
        if name in ("pixelate", "brightness", "impulse_noise", "shot_noise"):
            # an order-0 gather or exact arithmetic: equal
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"severity {sev}")


def test_jpeg_compression_requires_rgb():
    with pytest.raises(ValueError, match="RGB"):
        c.apply_corruption("jpeg_compression", torch.zeros((1, 16, 16, 1)), 1)


def test_registry_and_severity_rows_are_jaxs():
    assert c.CORRUPTION_NAMES == jax_c.CORRUPTION_NAMES
    assert c.DETERMINISTIC == jax_c.DETERMINISTIC
    for name in c.CORRUPTION_NAMES:
        for sev in (-3, 0, 1, 2, 3, 4, 5, 6, 99):
            want = np.asarray(jax_c.severity_row(name, sev))
            got = c.severity_row(name, sev)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(c.severity_row("fog", 0).numpy(), c.severity_row("fog", 1))
    np.testing.assert_array_equal(c.severity_row("fog", 9).numpy(), c.severity_row("fog", 5))


def test_apply_corruption_errors_and_generators():
    x = torch.from_numpy(_x()).double()
    with pytest.raises(KeyError, match="unknown corruption"):
        c.apply_corruption("frost", x, 1)
    for name in c.CORRUPTION_NAMES:
        if name in c.DETERMINISTIC:
            out = c.apply_corruption(name, x, 3)
            assert out.dtype == torch.float32  # the input is cast
            assert torch.equal(out, c.apply_corruption(name, x, 3, generator_from_seed(1)))
            assert c.draw_corruption(name, x, 3, generator_from_seed(1)) == ()
            continue
        with pytest.raises(ValueError, match="stochastic"):
            c.apply_corruption(name, x, 3)
        a = c.apply_corruption(name, x, 3, generator_from_seed(5))
        b = c.apply_corruption(name, x, 3, draws=c.draw_corruption(name, x, 3,
                                                                   generator_from_seed(5)))
        assert torch.equal(a, b), name
        assert not torch.equal(a, c.apply_corruption(name, x, 3, generator_from_seed(6))), name
        assert bool(torch.isfinite(a).all()) and 0.0 <= float(a.min()) <= float(a.max()) <= 1.0


def test_make_corruption_run_matches_manual():
    b = zoo.load_model("resnet_tiny", device="cpu")
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32))
    y = torch.tensor([0, 1, 2])
    for name in ("contrast", "gaussian_noise"):
        run = c.make_corruption_run(lf, name)
        got = run(x, y, 2, generator_from_seed(4))
        xc = c.apply_corruption(name, x, 2, generator_from_seed(4))
        assert got.dtype == torch.bool and got.shape == (3,)
        assert torch.equal(got, torch.argmax(lf(xc), -1) == y)


def test_tensor_quality_tables_are_jaxs_traced_tables():
    for q in range(1, 101):
        want = [np.asarray(t) for t in jax_jpeg._quant_tables_traced(jnp.float32(q))]
        got = [t.numpy() for t in jpeg_dct._quant_tables_tensor(torch.tensor(float(q)))]
        static = jpeg_dct._quant_tables(q)
        for g, w, s in zip(got, want, static):
            np.testing.assert_array_equal(g, w, err_msg=f"quality {q}")
            np.testing.assert_array_equal(g, s, err_msg=f"quality {q}")
    x = torch.from_numpy(_x())
    assert torch.equal(jpeg_dct.jpeg_dct_roundtrip(x, torch.tensor(18.0)),
                       jpeg_dct.jpeg_dct_roundtrip(x, 18))


# ---------------------------------------------------------------------------
# stream_correctness_cell

def _pngs(d, n, size=20, seed=11):
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rs.rand(size, size, 3) * 255).astype(np.uint8)).save(d / f"im_{i}.png")
    return sorted(d.iterdir())


@pytest.fixture(scope="module")
def tiny():
    b = zoo.load_model("resnet_tiny", device="cpu")
    lf = make_logits_fn(b.model, b.mean, b.std)
    return lf, lambda xx: torch.argmax(lf(xx), -1)


def test_stream_correctness_cell_equals_one_batch(tmp_path, tiny):
    """pixelate (deterministic): the streamed correctness of 7 images in
    chunks of 3 is the one-batch run's; clean_correct is all True under
    pseudo-labels.  gaussian_noise: each chunk equals a resident run of its
    images under ``chunk_generator(seed, cell, step)``."""
    lf, pseudo = tiny
    paths = _pngs(tmp_path, 7)
    x = torch.from_numpy(load_image_batch(paths, size=32))
    kw = {"seed": 1, "cell_id": "cell", "severity": 4, "chunk_size": 3,
          "place": make_placer("cpu"), "size": 32}
    run = c.make_corruption_run(lf, "pixelate")
    got = stream_correctness_cell(run, paths, pseudo_label_fn=pseudo, **kw)
    np.testing.assert_array_equal(got["correct"], run(x, pseudo(x), 4).numpy())
    assert got["clean_correct"].all() and got["correct"].dtype == bool
    run = c.make_corruption_run(lf, "gaussian_noise")
    got = stream_correctness_cell(run, paths, pseudo_label_fn=pseudo, **kw)
    want = []
    for step in range(3):
        xs = x[3 * step:3 * step + 3]
        n = xs.shape[0]
        xs = torch.cat([xs, xs[:1].expand(3 - n, -1, -1, -1)]) if n < 3 else xs
        want.append(run(xs, pseudo(xs), 4, chunk_generator(1, "cell", step)).numpy()[:n])
    np.testing.assert_array_equal(got["correct"], np.concatenate(want))


def test_stream_correctness_cell_resolved_labels_skip_the_pseudo_pass(tmp_path, tiny):
    lf, pseudo = tiny
    paths = _pngs(tmp_path, 5)
    run = c.make_corruption_run(lf, "pixelate")
    kw = {"seed": 0, "cell_id": "cell", "severity": 3, "chunk_size": 2,
          "place": make_placer("cpu"), "size": 32}
    calls = []

    def counted(xx):
        calls.append(1)
        return pseudo(xx)

    with_pseudo = stream_correctness_cell(run, paths, pseudo_label_fn=counted, **kw)
    assert len(calls) == 3
    labels = pseudo(torch.from_numpy(load_image_batch(paths, size=32))).numpy()
    calls.clear()
    resolved = stream_correctness_cell(run, paths, pseudo_label_fn=counted, labels=labels, **kw)
    assert not calls and "clean_correct" not in resolved
    np.testing.assert_array_equal(resolved["correct"], with_pseudo["correct"])
    # two ground-truth ids and three sentinels: the sentinels take the pseudo-label
    partial = stream_correctness_cell(run, paths, pseudo_label_fn=pseudo,
                                      labels=[labels[0], 9 - labels[1], -1, -1, -1], **kw)
    np.testing.assert_array_equal(partial["clean_correct"], [True, False, True, True, True])
    with pytest.raises(ValueError, match="labels or pseudo_label_fn"):
        stream_correctness_cell(run, paths, **kw)
    with pytest.raises(ValueError, match="UNLABELED"):
        stream_correctness_cell(run, paths, labels=[-1, 2, 0, 0, 0], **kw)


# ---------------------------------------------------------------------------
# the CLI

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("corruption_cli")
    images = root / "imgs"
    _pngs(images, 6, size=40, seed=2)
    rs = np.random.RandomState(0)
    module = jax_ibp.ibp_tiny()
    v = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(2),
                                            np.zeros((1, 32, 32, 3), np.float32)))
    v = {"params": {k: {kk: np.asarray(vv) + (0.3 * rs.randn(*vv.shape)).astype(np.float32)
                        for kk, vv in d.items()} for k, d in v["params"].items()}}
    weights = root / "ibp_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(v))
    return {"root": root, "images": images,
            "base": ["--image_dir", str(images), "--model", "ibp_tiny", "--weights", str(weights)]}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_parser_keeps_the_jax_flags():
    ours = {a.dest: (a.default, a.choices) for a in cli.build_parser()._actions}
    theirs = {a.dest: (a.default, a.choices) for a in jax_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == set()
    assert {k for k in theirs if ours[k] != theirs[k]} == set()


REPORT_KEYS = {"model", "n_images", "label_source", "severities", "clean_accuracy", "cells",
               "corruption_error", "mean_corruption_accuracy", "mean_corruption_error",
               "retained_accuracy"}
DET_ARGS = ["--corruptions", "contrast", "pixelate", "jpeg_compression", "saturate",
            "--severities", "1", "3", "5"]


def _lines(text: str) -> list[str]:
    """The per-corruption lines without their seconds, and the summary."""
    return [ln.rsplit(",", 1)[0] if ln.endswith("s)") else ln for ln in text.splitlines()
            if ": " in ln and ("(err " in ln or ln.startswith(("clean acc", "mean corr")))]


def test_cli_deterministic_cells_are_the_jax_clis(setup):
    out = {}
    for who, main, extra in (("ours", cli.main, ["--device", "cpu"]), ("theirs", jax_cli.main, [])):
        path = setup["root"] / f"c_{who}.json"
        text = _run(main, [*setup["base"], *DET_ARGS, "--output", str(path), *extra])
        out[who] = (text, json.loads(path.read_text()))
    (text_o, rep_o), (text_t, rep_t) = out["ours"], out["theirs"]
    assert set(rep_o) == set(rep_t) == REPORT_KEYS
    assert rep_o == rep_t
    assert _lines(text_o) == _lines(text_t) and len(_lines(text_o)) == 6
    accs = [v for row in rep_o["cells"].values() for v in row.values()]
    assert min(accs) < 1.0  # the weights make the corruptions change predictions


def test_cli_cells_are_position_independent(setup, monkeypatch):
    """A narrowed rerun reproduces a full run's cell: each cell's generator is
    ``cell_generator(seed, "<corruption>:s<severity>")``.  The cell here is a
    coin per image from its generator, so its accuracy shows the generator."""
    def coin_run(logits_fn, name):
        return lambda x, y, sev, g: torch.rand(x.shape[0], generator=g) < 0.5

    monkeypatch.setattr(cli, "make_corruption_run", coin_run)
    cells = []
    for names in (["gaussian_noise"], ["contrast", "brightness", "gaussian_noise"]):
        path = setup["root"] / f"pos_{len(names)}.json"
        _run(cli.main, [*setup["base"], "--device", "cpu", "--corruptions", *names,
                        "--severities", "2", "3", "--seed", "7", "--output", str(path)])
        cells.append(json.loads(path.read_text())["cells"])
    assert cells[0]["gaussian_noise"] == cells[1]["gaussian_noise"]
    for name, row in cells[1].items():
        for sev in (2, 3):
            coins = torch.rand(6, generator=cell_generator(7, cli.cell_id(name, sev))) < 0.5
            assert row[f"s{sev}"] == float(np.mean(coins.numpy())), (name, sev)


def test_cli_streamed_equals_resident_and_plots(setup):
    """6 images in chunks of 4: the deterministic cells and the clean
    accuracy equal the resident run's; --plot writes the heatmap."""
    reps = {}
    for mode, extra in (("resident", []), ("streamed", ["--max_batch", "4"])):
        path = setup["root"] / f"s_{mode}.json"
        text = _run(cli.main, [*setup["base"], "--device", "cpu", *DET_ARGS, "--output",
                               str(path), "--plot", str(setup["root"] / f"{mode}.png"), *extra])
        reps[mode] = json.loads(path.read_text())
        assert ("Streaming evaluation: 6 images in fixed chunks of 4" in text) == (
            mode == "streamed")
    assert reps["resident"] == reps["streamed"]
    with Image.open(setup["root"] / "streamed.png") as im:
        assert im.mode == "RGB" and im.size[0] >= 1000


def test_cli_refuses_unknown_corruptions_and_severities(setup):
    with pytest.raises(SystemExit, match="unknown corruptions"):
        cli.main([*setup["base"], "--corruptions", "frost"])
    with pytest.raises(SystemExit, match="severities must be in 1..5"):
        cli.main([*setup["base"], "--severities", "0", "3"])
