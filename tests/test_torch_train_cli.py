"""The port's adversarial_train CLI (cli/adversarial_train.py) against the
JAX package's on the CPU.

Both CLIs train ``wrn_tiny`` (``ibp_tiny`` for the certified objective)
from one Flax msgpack file on a 16-image CIFAR-10 archive written here, in
float32, the JAX CLI's draws (its key chain: ``fold_in(fold_in(key0,
epoch), step)`` a step, ``fold_in(key0, 10_000_019 + epoch)`` for the
robust validation) fed to the port through its draw functions.  Then:

- the per-epoch lines are JAX's (loss to 4 decimals, accuracies to 3; the
  ex/s left out), as are the calibration and ``Saved`` / ``Use it via``
  lines;
- the exported msgpack files hold the same tree, each leaf within
  ``EXPORT_TOL = 5e-4`` of the other relative to its largest entry (at
  least 1): float32 training in two frameworks (AdamW's first update is
  ±lr wherever the gradient is above its eps, so an entry whose gradient is
  within float32 noise of zero may move the other way), and the precise-BN
  variance is Flax's ``E[x²] - E[x]²`` in float32, which cancels; the
  port's file read by JAX's ``serialization.from_bytes`` gives JAX logits
  within ``LOGIT_TOL = 1e-5`` of the largest of the port's on the same
  file;
- a 1-epoch run and ``--resume`` export the bytes of the 2-epoch run, and
  ``--streaming`` gives the in-RAM run's lines (the port against itself,
  bit-equal on the CPU);
- the parser is JAX's but for ``--device``, and the refusals and warnings
  are JAX's.
"""

import io
import pickle
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

import _torch_train_helpers as H
from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.cli import adversarial_train as jax_cli
from image_recognition_adversarial_example_attack_tpu.core.normalize import (
    normalize_batch as jax_normalize)
from image_recognition_adversarial_example_attack_tpu.train import adversarial as jax_adv
from image_recognition_adversarial_example_attack_tpu_torch.cli import adversarial_train
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import normalize_batch
from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

EXPORT_TOL, LOGIT_TOL = 5e-4, 1e-5
N, BATCH, EPOCHS, SEED = 16, 8, 2, 3
# case -> (model, CLI flags, the JAX config its draws follow)
CASES = {
    "pgd-at+ema+robust": ("wrn_tiny", ["--attack_steps", "2", "--eval_attack_steps", "2",
                                       "--ema_decay", "0.9", "--lr", "1e-3"],
                          dict(attack_steps=2)),
    "trades+train_bn+crop-flip": ("wrn_tiny", ["--objective", "trades", "--attack_steps", "2",
                                               "--train_bn", "--augment", "crop-flip"],
                                  dict(attack_steps=2, aug_pad=4, aug_flip=True)),
    "crown-ibp": ("ibp_tiny", ["--objective", "crown-ibp", "--eps", "0.01", "--lr", "1e-3"],
                  dict()),
}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    d = root / "c10" / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rs = np.random.RandomState(21)
    rows = rs.randint(0, 256, (N, 3072)).astype(np.uint8)
    with open(d / "data_batch_1", "wb") as f:
        pickle.dump({b"data": rows, b"labels": rs.randint(0, 10, N).tolist()}, f)
    weights = {}
    for name in ("wrn_tiny", "ibp_tiny"):
        var = H.variables(name, seed=6, dtype=np.float32)
        weights[name] = root / f"{name}.msgpack"
        weights[name].write_bytes(serialization.to_bytes(var))
    return {"root": root, "c10": root / "c10", "weights": weights}


def _base(files, model, out):
    return ["--cifar10_dir", str(files["c10"]), "--model", model, "--weights",
            str(files["weights"][model]), "--epochs", str(EPOCHS), "--batch_size", str(BATCH),
            "--seed", str(SEED), "--out", str(out)]


def _jax_draws(extra: dict, objective: str, eval_steps: int, eps: float) -> dict:
    """The JAX CLI's draws in the port's call order, by draw function."""
    cfg = jax_adv.AdvTrainConfig(eps=eps, **extra)
    key0 = jax.random.PRNGKey(SEED)
    queue = {"start": [], "trades": [], "augment": []}
    for epoch in range(EPOCHS):
        ek = jax.random.fold_in(key0, epoch)
        for s in range(N // BATCH):
            draws = H.step_draws(objective, cfg, jax.random.fold_in(ek, s),
                                 (BATCH, 32, 32, 3), jnp.float32)
            for k, v in draws.items():
                queue[k].extend(v)
        if eval_steps:
            k = jax.random.fold_in(key0, 10_000_019 + epoch)
            queue["start"].append(H.t(jax.random.uniform(k, (N, 32, 32, 3), jnp.float32,
                                                          -eps, eps)))
    return queue


def _lines(text: str) -> list[str]:
    keep = ("epoch ", "Calibrating", "Saved", "Use it via", "WARNING", "Dataset")
    return [re.sub(r" \(\S+ ex/s\)$", "", ln.replace("_jax.msgpack", ".msgpack")
                   .replace("_port.msgpack", ".msgpack"))
            for ln in text.splitlines() if ln.startswith(keep)]


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, files):
    """Both CLIs on one case: (case, JAX stdout, port stdout, JAX file, port
    file)."""
    case = request.param
    model, flags, extra = CASES[case]
    objective = "trades" if "trades" in case else "ibp" if "ibp" in case else "pgd-at"
    eps = 0.01 if model == "ibp_tiny" else 8 / 255
    out_j, out_p = files["root"] / f"{case}_jax.msgpack", files["root"] / f"{case}_port.msgpack"
    theirs = _run(jax_cli.main, [*_base(files, model, out_j), *flags])
    queue = _jax_draws(extra, objective, 2 if "robust" in case else 0, eps)
    with pytest.MonkeyPatch.context() as mp:
        feeder = H.Feeder(mp)
        feeder.add(queue)
        ours = _run(adversarial_train.main, [*_base(files, model, out_p), *flags,
                                             "--device", "cpu"])
        assert feeder.empty()
    return case, theirs, ours, out_j, out_p


def test_console_lines_equal_jaxs(runs):
    case, theirs, ours, _, _ = runs
    got, want = _lines(ours), _lines(theirs)
    assert got == want
    assert len([ln for ln in got if ln.startswith("epoch ")]) == EPOCHS
    if "robust" in case:
        assert "ema_clean_acc=" in got[1] and "robust_acc@pgd2=" in got[1]
    if "ibp" in case:
        assert "verified_acc@0.01=" in got[1]
    if "train_bn" in case:
        assert f"Calibrating BatchNorm running statistics ({N} images, precise-BN sweep)..." in got
    assert ours.startswith("Using device: cpu")


def test_exports_agree_and_load_in_both_packages(runs, files):
    """The two exports hold one tree within EXPORT_TOL; the port's file
    through JAX's from_bytes gives the port's logits."""
    case, _, _, out_j, out_p = runs
    model = CASES[case][0]
    template = H.variables(model, seed=6, dtype=np.float32)
    theirs = serialization.from_bytes(template, out_j.read_bytes())
    ours = serialization.from_bytes(template, out_p.read_bytes())
    flat_o = jax.tree_util.tree_leaves_with_path(ours)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert len(flat_o) == len(flat_t)
    for path, leaf in flat_o:
        assert leaf.dtype == np.float32
        want_leaf = np.asarray(flat_t[path])
        err = np.abs(np.asarray(leaf) - want_leaf).max() / max(1.0, np.abs(want_leaf).max())
        assert err < EXPORT_TOL, (path, err)
    x = np.random.RandomState(2).rand(4, 32, 32, 3).astype(np.float32)
    mean, std = H.stats(model)
    want = np.asarray(H.jax_module(model, jnp.float32).apply(
        ours, jax_normalize(jnp.asarray(x), mean, std)))
    bundle = load_model(model, weights=out_p, device="cpu")
    assert bundle.source == "cache"
    with torch.no_grad():
        got = bundle.model(normalize_batch(torch.from_numpy(x), mean, std).permute(0, 3, 1, 2))
    assert np.abs(got.numpy() - want).max() < LOGIT_TOL * np.abs(want).max()


def test_resume_and_streaming_are_exact(tmp_path):
    """On a PNG tree: 2 epochs in RAM; 1 epoch, then --resume to 2 (the
    same export, bytes and all, and the same second epoch line); 2 epochs
    --streaming (the same lines: every image decodes)."""
    data = tmp_path / "tree"
    rs = np.random.RandomState(9)
    for c in range(2):
        (data / f"c{c}").mkdir(parents=True)
        for i in range(6):
            Image.fromarray((rs.rand(40, 36, 3) * 255).astype(np.uint8)).save(
                data / f"c{c}" / f"{i}.png")
    common = ["--data_dir", str(data), "--model", "wrn_tiny", "--device", "cpu",
              "--batch_size", "4", "--attack_steps", "1", "--ema_decay", "0.5", "--lr", "1e-3",
              "--cutout", "6"]
    full = _run(adversarial_train.main, [*common, "--epochs", "2", "--out",
                                         str(tmp_path / "full.msgpack")])
    one = _run(adversarial_train.main, [*common, "--epochs", "1", "--out",
                                        str(tmp_path / "res.msgpack")])
    resumed = _run(adversarial_train.main, [*common, "--epochs", "2", "--resume", "--out",
                                            str(tmp_path / "res.msgpack")])
    streamed = _run(adversarial_train.main, [*common, "--epochs", "2", "--streaming", "--out",
                                             str(tmp_path / "stream.msgpack")])
    epochs = lambda text: [ln for ln in _lines(text) if ln.startswith("epoch ")]  # noqa: E731
    assert "Resumed from" in resumed and "step=3, continuing at epoch 2" in resumed
    assert epochs(one) == [epochs(full)[0].replace("epoch 1/2", "epoch 1/1")]
    assert epochs(resumed) == epochs(full)[1:]
    assert epochs(streamed) == epochs(full)
    assert (tmp_path / "res.msgpack").read_bytes() == (tmp_path / "full.msgpack").read_bytes()
    assert (tmp_path / "stream.msgpack").read_bytes() == (tmp_path / "full.msgpack").read_bytes()
    a = torch.load(tmp_path / "full.msgpack.ckpt", weights_only=True)
    b = torch.load(tmp_path / "res.msgpack.ckpt", weights_only=True)
    assert a["step"] == b["step"] == 6 and a["epoch"] == b["epoch"] == 1
    assert all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())


def test_parser_equals_jaxs_but_for_device():
    ours = {a.dest: (a.default, a.choices, a.nargs, a.const)
            for a in adversarial_train.build_parser()._actions}
    theirs = {a.dest: (a.default, a.choices, a.nargs, a.const)
              for a in jax_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == set()
    assert {k for k in theirs if ours[k] != theirs[k]} == set()


@pytest.mark.parametrize("flags", [
    [], ["--data_dir", "D", "--cifar10_dir", "C"], ["--cifar10_dir", "C", "--streaming"],
    ["--cifar10_dir", "C", "--model", "resnet_tiny"],
    ["--data_dir", "T", "--model", "resnet_tiny", "--train_bn"],
    ["--cifar10_dir", "C", "--model", "wrn_tiny", "--objective", "free", "--grad_accum", "2"],
    ["--cifar10_dir", "C", "--model", "wrn_tiny", "--objective", "ibp"],
    ["--cifar10_dir", "C", "--model", "ibp_tiny", "--objective", "ibp", "--train_bn"]],
    ids=["no_data", "two_data", "cifar_streaming", "not_32", "train_bn_resnet", "free_accum",
         "ibp_not_spec", "ibp_train_bn"])
def test_refusals_equal_jaxs(flags, files, tmp_path):
    tree = tmp_path / "tree" / "c0"
    tree.mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tree / "a.png")
    subs = {"C": str(files["c10"]), "D": str(tmp_path), "T": str(tree.parent)}
    flags = [subs.get(f, f) for f in flags]
    flags += ["--out", str(tmp_path / "w.msgpack")]
    msgs = []
    for main, dev in ((jax_cli.main, []), (adversarial_train.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e, redirect_stdout(io.StringIO()):
            main([*flags, *dev])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and len(msgs[0]) > 10
    assert not (tmp_path / "w.msgpack").exists()


def test_warnings_equal_jaxs(files, tmp_path):
    flags = [*_base(files, "wrn_tiny", tmp_path / "w.msgpack"), "--objective", "mart",
             "--noise_sigma", "0.1", "--clean_weight", "0.2", "--epochs", "0",
             "--eval_attack_steps", "0"]
    texts = [_run(jax_cli.main, flags), _run(adversarial_train.main, [*flags, "--device", "cpu"])]
    warnings = [[ln for ln in t.splitlines() if ln.startswith("WARNING")] for t in texts]
    assert warnings[0] == warnings[1] and len(warnings[0]) == 2


def test_the_card_is_the_default_device(files, tmp_path):
    """Without --device the CLI asks for the card and raises where there is
    none, after the refusals that need no device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adversarial_train.main(_base(files, "wrn_tiny", tmp_path / "w.msgpack"))
    with pytest.raises(SystemExit, match="exactly one of"):
        adversarial_train.main([])
