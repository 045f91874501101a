"""The CIFAR-10 data plane of the port (core/datasets.py::load_cifar10) and
the ``--cifar10_dir`` paths of its grid and robust_eval CLIs, against the
JAX package on the CPU.

The archives are written here from a numpy seed, in both layouts
(``cifar-10-batches-py`` pickles, ``cifar-10-batches-bin`` records) and as
loose batch files.  Both CLIs load the same ``wrn_tiny`` weights from one
Flax msgpack file and read the same ten images, whose labels are the JAX
model's predictions with three of them moved, so that the clean accuracy
is 0.7 and the attacks have correct samples to flip.  The draws are JAX's,
replayed from its key chain and fed to the port through
``attacks.pgd.draw_start`` (the grid's PGD start), ``attacks.apgd.draw_start``
and ``attacks.square.draw_square`` (the lite protocol): then the summary
lines and the robust-accuracy lines are the JAX CLI's.
"""

import io
import json
import pickle
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_blackbox_helpers import square_draws
from _torch_cli_helpers import SUMMARY, summary_lines
from _torch_port_helpers import flax_init, init_shaped
from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_scaleout_helpers import seeded_tree
from image_recognition_adversarial_example_attack_tpu.cli import defense_experiments as jax_grid
from image_recognition_adversarial_example_attack_tpu.cli import robust_eval as jax_re_cli
from image_recognition_adversarial_example_attack_tpu.cli.common import cell_key
from image_recognition_adversarial_example_attack_tpu.core import datasets as jax_datasets
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    CIFAR10_MEAN, CIFAR10_STD)
from image_recognition_adversarial_example_attack_tpu.core.normalize import normalize_batch
from image_recognition_adversarial_example_attack_tpu.eval.engine import Engine
from image_recognition_adversarial_example_attack_tpu.models import wideresnet as jax_wrn
from image_recognition_adversarial_example_attack_tpu_torch.attacks import apgd, pgd, square
from image_recognition_adversarial_example_attack_tpu_torch.cli import defense_experiments
from image_recognition_adversarial_example_attack_tpu_torch.cli import robust_eval
from image_recognition_adversarial_example_attack_tpu_torch.core import datasets
from image_recognition_adversarial_example_attack_tpu_torch.models import wideresnet as port_wrn

N, EPS = 10, 0.004
GRID = ["--model", "wrn_tiny", "--attacks", "fgsm", "pgd", "--steps", "2", "--eps_list",
        str(EPS), "--viz_samples", "0"]
RE_CUT = ["--model", "wrn_tiny", "--apgd_steps", "2", "--square_steps", "4",
          "--deepfool_steps", "2", "--eps_list", str(EPS)]
SQUARE_STEPS = 4


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 3072)).astype(np.uint8), rng.randint(0, 10, n)


def _write_py(d, name, rows, labels, str_keys=False):
    d.mkdir(parents=True, exist_ok=True)
    keys = ("data", "labels") if str_keys else (b"data", b"labels")
    with open(d / name, "wb") as f:
        pickle.dump({keys[0]: rows, keys[1]: [int(v) for v in labels]}, f)


def _write_bin(d, name, rows, labels):
    d.mkdir(parents=True, exist_ok=True)
    rec = np.concatenate([np.asarray(labels, np.uint8)[:, None], rows], axis=1)
    (d / name).write_bytes(rec.tobytes())


def _archive(root, layout, str_keys=False):
    """Two train batches and a test batch in ``layout``."""
    py = layout.startswith("py")
    sub = {"py": "cifar-10-batches-py", "bin": "cifar-10-batches-bin"}[layout.split("_")[0]]
    d = root if layout.endswith("_flat") else root / sub
    for i, name in enumerate(("data_batch_1", "data_batch_2", "test_batch")):
        rows, labels = _rows(4 + i, seed=i)
        if py:
            _write_py(d, name, rows, labels, str_keys)
        else:
            _write_bin(d, name + ".bin", rows, labels)
    return root


@pytest.mark.parametrize("layout", ["py", "bin", "py_flat", "bin_flat"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_cifar10_equals_jaxs(tmp_path, layout, split):
    root = _archive(tmp_path, layout, str_keys=layout == "py_flat")
    x, y = datasets.load_cifar10(root, split=split)
    want_x, want_y = jax_datasets.load_cifar10(root, split=split)
    assert x.dtype == want_x.dtype == np.float32 and y.dtype == want_y.dtype == np.int32
    assert x.shape == want_x.shape == ((9 if split == "train" else 6), 32, 32, 3)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(y, want_y)
    assert 0.0 <= x.min() and x.max() <= 1.0
    # channel-planar rows: pixel (0, 1) of image 0 reads bytes 1, 1025, 2049
    rows, _ = _rows(6 if split == "test" else 4, seed=2 if split == "test" else 0)
    np.testing.assert_array_equal(x[0, 0, 1] * 255, rows[0, [1, 1025, 2049]].astype(np.float32))


def _errors(fn, root, **kw):
    try:
        fn(root, **kw)
    except (ValueError, FileNotFoundError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("case", ["split", "empty", "no_test_py", "no_test_bin", "bad_bin"])
def test_load_cifar10_errors_equal_jaxs(tmp_path, case):
    kw = {"split": "test"}
    if case == "split":
        kw = {"split": "val"}
    elif case == "no_test_py":
        _write_py(tmp_path / "cifar-10-batches-py", "data_batch_1", *_rows(2, 0))
    elif case == "no_test_bin":
        _write_bin(tmp_path / "cifar-10-batches-bin", "data_batch_1.bin", *_rows(2, 0))
    elif case == "bad_bin":
        (tmp_path / "test_batch.bin").write_bytes(b"\0" * 3072)
    theirs = _errors(jax_datasets.load_cifar10, tmp_path, **kw)
    assert _errors(datasets.load_cifar10, tmp_path, **kw) == theirs
    assert theirs[0] is (ValueError if case in ("split", "bad_bin") else FileNotFoundError)


# ---------------------------------------------------------------------------
# the CLIs on one archive and one set of weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar_cli")
    module = jax_wrn.wrn_tiny()
    variables = init_shaped(seeded_tree(port_wrn.wrn_tiny(), "wideresnet"), module)
    rs = np.random.RandomState(5)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * rs.randn(*np.shape(a))).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    weights = root / "wrn_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(variables))
    rows, _ = _rows(N, seed=7)
    x = rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    pred = np.asarray(jax.jit(module.apply)(
        variables, normalize_batch(x, CIFAR10_MEAN, CIFAR10_STD))).argmax(-1)
    labels = pred.copy()
    labels[[1, 4, 8]] = (pred[[1, 4, 8]] + 1) % 10  # clean accuracy 0.7
    flax_init(module)  # the JAX CLIs' template for the weights (jax_zoo_init_once)
    _write_py(root / "c10" / "cifar-10-batches-py", "test_batch", rows, labels)
    return {"root": root, "x": x, "labels": labels, "pred": pred,
            "base": ["--cifar10_dir", str(root / "c10"), "--weights", str(weights)]}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@jax.jit
def _uniform(key, eps, shape_like):
    return jax.random.uniform(key, shape_like.shape, jnp.float32, minval=-eps, maxval=eps)


def test_grid_summary_lines_equal_jaxs(setup, monkeypatch):
    """fgsm and pgd (2 steps, the JAX CLI's random start) on the archive: the
    loaded-split line, the clean accuracy and the six-field summary lines are
    the JAX CLI's."""
    theirs = _run(jax_grid.main, [*setup["base"], *GRID,
                                  "--output_dir", str(setup["root"] / "grid_jax")])
    # the JAX grid pads the batch to its mesh; the port takes the first N rows
    padded = Engine(use_mesh=True).batch_from_array(setup["x"]).x.shape
    noise = np.asarray(_uniform(cell_key(jax.random.PRNGKey(0), f"pgd:{EPS:.6f}"),
                                jnp.float32(EPS),
                                jnp.zeros(padded, jnp.float32)))[:N]
    calls = []

    def fed(shape, eps, generator, device):
        calls.append(tuple(shape))
        return torch.from_numpy(noise).to(device)

    monkeypatch.setattr(pgd, "draw_start", fed)
    ours = _run(defense_experiments.main, [*setup["base"], *GRID, "--device", "cpu",
                                           "--output_dir", str(setup["root"] / "grid_port")])
    assert calls == [(N, 32, 32, 3)]
    lines = summary_lines(ours)
    assert len(lines) == 2 and all(SUMMARY.match(ln) for ln in lines)
    assert lines == summary_lines(theirs)
    for text in (ours, theirs):
        assert f"Loaded CIFAR-10 test split: {N} images" in text
        assert "clean accuracy vs CIFAR-10 test labels: 0.700" in text
    thr = [re.search(r"Auto-calibrated threshold: (\S+)", t)[1] for t in (ours, theirs)]
    assert thr[0] == thr[1]
    partial = json.loads((setup["root"] / "grid_port" / "results_partial.json").read_text())
    assert {c["count"] for c in partial.values()} == {N}
    assert float(lines[1].split("attack_success=")[1].split(",")[0]) > 0.3


def test_grid_cifar10_n_caps_and_is_resident(setup):
    text = _run(defense_experiments.main, [
        *setup["base"], *GRID[:4], "--eps_list", str(EPS), "--viz_samples", "0", "--device",
        "cpu", "--cifar10_n", "4", "--max_batch", "2",
        "--output_dir", str(setup["root"] / "grid_cap")])
    assert "Loaded CIFAR-10 test split: 4 images" in text and "Streaming" not in text
    acc = float(np.mean(setup["labels"][:4] == setup["pred"][:4]))
    assert f"clean accuracy vs CIFAR-10 test labels: {acc:.3f}" in text


def _robust_lines(text):
    return [re.sub(r"  \[\d+\.\ds\]$", "", ln) for ln in text.splitlines()
            if ln.startswith("eps=")]


def test_robust_eval_lines_equal_jaxs(setup, monkeypatch):
    """The lite protocol at cut budgets on the archive's labels: the clean
    accuracy, the robust accuracy and each arm's count are the JAX CLI's on
    its draws."""
    theirs = _run(jax_re_cli.main, [*setup["base"], *RE_CUT,
                                    "--output", str(setup["root"] / "re_jax.json")])
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    k_apgd, k_square = jax.random.split(sub)
    shape = (N, 32, 32, 3)
    start = np.asarray(_uniform(k_apgd, jnp.float32(EPS), jnp.zeros(shape, jnp.float32)))
    stripes, r0, c0, signs = square_draws(k_square, SQUARE_STEPS, shape)
    monkeypatch.setattr(apgd, "draw_start",
                        lambda *a, **k: torch.from_numpy(start))
    monkeypatch.setattr(square, "draw_square",
                        lambda *a, **k: (stripes.float(), r0, c0, signs.float()))
    out = setup["root"] / "re_port.json"
    ours = _run(robust_eval.main, [*setup["base"], *RE_CUT, "--device", "cpu",
                                   "--output", str(out)])
    assert "clean accuracy vs CIFAR-10 test labels: 0.700" in ours
    assert "clean accuracy vs CIFAR-10 test labels: 0.700" in theirs
    assert _robust_lines(ours) == _robust_lines(theirs) and len(_robust_lines(ours)) == 1
    rows_o = json.loads(out.read_text())["results"]
    rows_t = json.loads((setup["root"] / "re_jax.json").read_text())["results"]
    assert rows_o == rows_t and rows_o[0]["count"] == N
    assert 0.0 < rows_o[0]["robust_accuracy"] < 1.0 and rows_o[0]["success_apgd"] > 0


@pytest.mark.parametrize("cli", ["grid", "robust_eval"])
@pytest.mark.parametrize("case", ["not_32", "imagenet_val", "labels_json"])
def test_cifar10_refusals(setup, tmp_path, cli, case):
    """A model that is not 32x32 is refused (after loading, as in JAX);
    ``--imagenet_val_dir`` beside ``--cifar10_dir`` before any device work;
    the grid refuses ``--labels_json`` too (robust_eval reads the archive's
    labels and ignores it, as JAX's does)."""
    main = defense_experiments.main if cli == "grid" else robust_eval.main
    argv = [*setup["base"][:2], "--output_dir" if cli == "grid" else "--output",
            str(tmp_path / "o")]
    if case == "not_32":
        argv += ["--model", "resnet_tiny", "--device", "cpu"]
        with pytest.raises(SystemExit, match="32x32"):
            _run(main, argv)
        return
    argv += ["--model", "wrn_tiny", "--device", "cuda"]  # refused before the device rule
    if case == "imagenet_val":
        with pytest.raises(SystemExit, match="at most one of --imagenet_val_dir"):
            _run(main, [*argv, "--imagenet_val_dir", str(tmp_path)])
    elif cli == "grid":
        with pytest.raises(SystemExit, match="drop --labels_json"):
            _run(main, [*argv, "--labels_json", str(tmp_path / "l.json")])
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run(main, [*argv, "--labels_json", str(tmp_path / "l.json")])


def test_grid_parser_equals_jaxs_but_for_device():
    ours = {a.dest: (a.default, a.choices) for a in defense_experiments.build_parser()._actions}
    theirs = {a.dest: (a.default, a.choices) for a in jax_grid.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == set()
    assert {k for k in theirs if ours[k] != theirs[k]} == set()
