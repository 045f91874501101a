"""The port's Flax msgpack reader and writer (models/flax_msgpack.py), its
inverse bridge ``to_jax_variables`` and the zoo's search order, against
``flax.serialization`` and the JAX zoo on the CPU."""

import warnings

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo
from image_recognition_adversarial_example_attack_tpu_torch.models import flax_msgpack as fm
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables, to_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.models.resnet import resnet_tiny


@pytest.fixture(scope="module")
def tiny64():
    """resnet_tiny's Flax module and perturbed float64 variables."""
    with jax.enable_x64():
        return flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_port_reads_flax_to_bytes_and_computes_the_same_logits(tiny64, tmp_path):
    """A file written by flax.serialization.to_bytes loads into the port's
    ResNet with every leaf bit-equal; float64 logits agree within 1e-9."""
    module, variables = tiny64
    path = tmp_path / "resnet_tiny.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    tree = fm.read_variables(path)
    assert _same_tree(tree, variables)
    model = port_resnet("resnet_tiny", tree, np.float64, num_classes=10)
    x = np.random.RandomState(0).uniform(0, 1, (3, 32, 32, 3))
    with jax.enable_x64():
        fns = uncast_fns(module, variables, model)
        want = np.asarray(fns["jax"][0](jnp.asarray(x)))
    got = fns["port"][0](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_flax_reads_the_port_files(tiny64, tmp_path):
    """flax.serialization.msgpack_restore reads save_variables' file to the
    same tree; the bytes are to_bytes' own."""
    _, variables = tiny64
    path = tmp_path / "out" / "w.msgpack"
    fm.save_variables(variables, path)
    assert _same_tree(serialization.msgpack_restore(path.read_bytes()), variables)
    assert path.read_bytes() == serialization.to_bytes(jax.device_get(variables))


def test_chunked_arrays_both_ways(tiny64, monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes go in flax's chunked form."""
    _, variables = tiny64
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 100)
    flax_bytes = serialization.to_bytes(variables)
    assert b"__msgpack_chunked_array__" in flax_bytes
    assert _same_tree(fm.msgpack_restore(flax_bytes), variables)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 100)
    port_bytes = fm.to_bytes(variables)
    assert port_bytes == flax_bytes
    assert _same_tree(serialization.msgpack_restore(port_bytes), variables)


def test_dtypes_scalars_and_plain_values():
    tree = {
        "bf16": jnp.asarray([[1.5, -2.0, 3.25]], jnp.bfloat16),
        "f16": np.asarray([0.5, -1.0], np.float16),
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "i8": np.asarray([-128, 127], np.int8),
        "i32": np.asarray([1 << 30], np.int32),
        "u8": np.asarray([255], np.uint8),
        "bool": np.asarray([True, False]),
        "scalar": np.float32(2.5),
        "step": 123456789012,
        "neg": -70000,
        "rate": 0.125,
        "name": "x" * 40,
        "none": None,
        "flag": True,
    }
    got = fm.msgpack_restore(serialization.msgpack_serialize(dict(tree)))
    assert got["bf16"].dtype == torch.bfloat16
    assert got["bf16"].float().tolist() == [[1.5, -2.0, 3.25]]
    for k in ("f16", "f32", "i8", "i32", "u8", "bool"):
        assert got[k].dtype == tree[k].dtype and np.array_equal(got[k], tree[k]), k
    assert isinstance(got["scalar"], np.float32) and got["scalar"] == 2.5
    assert {k: got[k] for k in ("step", "neg", "rate", "name", "none", "flag")} == {
        k: tree[k] for k in ("step", "neg", "rate", "name", "none", "flag")}


@pytest.mark.parametrize("case", ["complex_ext", "unknown_ext", "unknown_dtype", "truncated"])
def test_what_the_reader_refuses(case):
    if case == "complex_ext":  # flax's ext type 2, a Python complex
        data, match = serialization.msgpack_serialize({"c": 1 + 2j}), "ext type 2"
    elif case == "unknown_ext":
        data, match = msgpack.packb({"a": msgpack.ExtType(7, b"abc")}), "ext type 7"
    elif case == "unknown_dtype":
        inner = msgpack.packb(((1,), "complex64", b"\0" * 8), use_bin_type=True)
        data, match = msgpack.packb({"a": msgpack.ExtType(1, inner)}), "unknown dtype 'complex64'"
    else:
        data, match = serialization.msgpack_serialize({"a": np.zeros(4)})[:-3], "truncated"
    with pytest.raises(ValueError, match=match):
        fm.msgpack_restore(data)


def test_to_jax_variables_inverts_the_bridge(tiny64):
    """to_jax_variables gives the Flax tree (same paths and shapes as the
    JAX module's own variables), and from_jax_variables gives back the
    state dict bit for bit."""
    _, variables = tiny64
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    tree = to_jax_variables(model, "resnet")
    assert _same_tree(tree, variables)
    back = from_jax_variables(tree, "resnet")
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def _write_pth(path, variables):
    torch.save(from_jax_variables(variables, "resnet"), path)


def _params_equal(model, variables) -> bool:
    want = from_jax_variables(variables, "resnet")
    return all(torch.equal(v, want[k].to(v.dtype)) for k, v in model.state_dict().items())


@pytest.mark.parametrize("layout,want", [
    ("explicit_msgpack", "cache"),
    ("explicit_pth", "converted"),
    ("dir_both", "cache"),
    ("dir_pth", "converted"),
    ("dir_msgpack", "cache"),
    ("empty", "random"),
])
def test_search_order_and_source_as_jax(layout, want, tmp_path, monkeypatch):
    """--weights first, then <dir>/<name>.msgpack, then <dir>/<name>.pth;
    the port's ``source`` is the JAX zoo's for each layout, and the file
    that wins is the one loaded."""
    other = to_jax_variables(resnet_tiny(), "resnet")  # the .pth files' weights
    rs = np.random.RandomState(1)
    cache = jax.tree_util.tree_map(  # the .msgpack files' weights
        lambda a: (a + rs.uniform(0.5, 1.0, a.shape)).astype(np.float32), other)
    wdir = tmp_path / "weights"
    wdir.mkdir()
    monkeypatch.setenv("ADV_TPU_WEIGHTS_DIR", str(wdir))
    weights, winner = None, None
    if layout == "explicit_msgpack":
        weights, winner = tmp_path / "mine.msgpack", cache
        fm.save_variables(cache, weights)
        _write_pth(wdir / "resnet_tiny.pth", other)
    elif layout == "explicit_pth":
        weights, winner = tmp_path / "mine.pth", other
        _write_pth(weights, other)
        fm.save_variables(cache, wdir / "resnet_tiny.msgpack")
    elif layout == "dir_both":
        fm.save_variables(cache, wdir / "resnet_tiny.msgpack")
        _write_pth(wdir / "resnet_tiny.pth", other)
        winner = cache
    elif layout == "dir_pth":
        _write_pth(wdir / "resnet_tiny.pth", other)
        winner = other
    elif layout == "dir_msgpack":
        fm.save_variables(cache, wdir / "resnet_tiny.msgpack")
        winner = cache
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bundle = zoo.load_model("resnet_tiny", weights=weights, device="cpu")
        theirs = jax_zoo.load_model("resnet_tiny", weights=weights, cache_converted=False)
    assert bundle.source == theirs.source == want
    if winner is not None:
        assert _params_equal(bundle.model, winner)


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_a_partial_tree_raises(fault, tmp_path):
    tree = to_jax_variables(resnet_tiny(), "resnet")
    if fault == "missing":
        del tree["params"]["layer2_0"]["conv1"]
    else:
        tree["params"]["layer2_0"]["conv9"] = {"kernel": np.zeros((1, 1, 4, 4), np.float32)}
    path = tmp_path / "bad.msgpack"
    fm.save_variables(tree, path)
    with pytest.raises(RuntimeError, match="Missing key" if fault == "missing" else "Unexpected"):
        zoo.load_model("resnet_tiny", weights=path, device="cpu")


def test_weights_msgpack_is_no_longer_ignored(tiny64, tmp_path):
    """The fault: ``--weights x.msgpack`` warned "no weights found" and ran
    the random init.  Now the file's weights run, as in the JAX package."""
    _, variables = tiny64
    path = tmp_path / "robust.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bundle = zoo.load_model("resnet_tiny", weights=str(path), device="cpu")
    assert not [w for w in caught if "no weights found" in str(w.message)]
    assert bundle.source == "cache"
    assert _params_equal(bundle.model, variables)
