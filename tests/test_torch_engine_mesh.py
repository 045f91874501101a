"""The port's batch engine (eval/engine.py), the mesh's data axis
(parallel/mesh.py) and the images helpers they and serve use
(core/images.py: ``pad_batch``, ``load_image_bytes``) against the JAX
package's on the CPU.

- ``pad_batch`` and ``load_image_bytes`` equal JAX's (bit for bit).
- ``make_mesh``'s shapes and errors equal JAX's over the same device
  counts (JAX over ``jax.devices()[:k]`` of conftest's eight CPU devices,
  the port over ``[cpu] * k``).
- ``shard_batch`` splits a batch into JAX's per-device shards (the same
  rows on each device) and gathers back to the unsplit batch;
  ``replicated_sharding`` puts the whole batch on every device.
- ``Engine``/``Batch``/``unpad`` equal JAX's with and without a mesh.
"""

import io
import itertools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.core import images as jax_images
from image_recognition_adversarial_example_attack_tpu.eval import engine as jax_engine
from image_recognition_adversarial_example_attack_tpu.parallel import mesh as jax_mesh
from image_recognition_adversarial_example_attack_tpu_torch.core import images
from image_recognition_adversarial_example_attack_tpu_torch.eval.engine import Batch, Engine
from image_recognition_adversarial_example_attack_tpu_torch.parallel import (
    ShardedTensor, data_sharding, make_mesh, replicated_sharding, shard_batch)

CPU = torch.device("cpu")


def _batch(n: int, size: int = 8, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("n,multiple", [(1, 1), (5, 1), (5, 2), (6, 3), (7, 4), (3, 8),
                                        (8, 8), (2, 0)])
def test_pad_batch_equals_jaxs(n, multiple):
    x = _batch(n)
    ours, n_ours = images.pad_batch(x, multiple)
    theirs, n_theirs = jax_images.pad_batch(x, multiple)
    assert n_ours == n_theirs == n
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("size", [224, 32, 16])
def test_load_image_bytes_equals_jaxs_and_load_image(fmt, size, tmp_path):
    rs = np.random.RandomState(size)
    img = Image.fromarray((rs.rand(70, 90, 3) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    raw = buf.getvalue()
    ours = images.load_image_bytes(raw, size=size)
    assert ours.shape == (size, size, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_images.load_image_bytes(raw, size=size))
    path = tmp_path / f"x.{fmt.lower()}"
    path.write_bytes(raw)
    np.testing.assert_array_equal(ours, images.load_image(path, size=size)[0])


def _outcome(fn):
    try:
        return ("ok", dict(fn().shape))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n_total", [1, 2, 4, 8])
def test_make_mesh_shapes_and_errors_equal_jaxs(n_total):
    for n_data, n_model in itertools.product([None, 1, 2, 3, 4, 16], [1, 2, 3]):
        ours = _outcome(lambda: make_mesh(n_data, n_model, devices=[CPU] * n_total))
        theirs = _outcome(lambda: jax_mesh.make_mesh(n_data, n_model,
                                                     devices=jax.devices()[:n_total]))
        assert ours == theirs, (n_total, n_data, n_model)


def test_mesh_axes_and_device_grid():
    devs = [torch.device("cpu", i) for i in range(6)]  # distinct labels, to read the grid
    mesh = make_mesh(n_data=3, n_model=2, devices=devs)
    jm = jax_mesh.make_mesh(n_data=3, n_model=2, devices=jax.devices()[:6])
    assert mesh.axis_names == tuple(jm.axis_names) == ("data", "model")
    assert [[d.index for d in row] for row in mesh.devices] == [
        [jax.devices().index(d) for d in row] for row in jm.devices]


@pytest.mark.parametrize("k,n_model", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2)])
def test_shard_batch_splits_as_jax_and_gathers_back(k, n_model):
    x = _batch(8, seed=k)
    mesh = make_mesh(n_model=n_model, devices=[CPU] * k)
    jm = jax_mesh.make_mesh(n_model=n_model, devices=jax.devices()[:k])
    placed = shard_batch(x, mesh)
    assert isinstance(placed, ShardedTensor) and tuple(placed.shape) == x.shape
    jx = jax_mesh.shard_batch(x, jm)
    want = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
    flat = [d for row in jm.devices for d in row]
    assert len(placed.shards) == len(flat) == k
    for shard, dev in zip(placed.shards, flat):
        np.testing.assert_array_equal(shard.numpy(), want[dev])
        assert shard.is_contiguous()
    np.testing.assert_array_equal(placed.gather().numpy(), x)
    np.testing.assert_array_equal(data_sharding(mesh).place(torch.from_numpy(x)).gather().numpy(),
                                  x)


def test_replicated_sharding_puts_the_whole_batch_everywhere():
    x = _batch(3)
    mesh = make_mesh(devices=[CPU] * 4)
    placed = replicated_sharding(mesh).place(x)
    assert len(placed.shards) == 4 and tuple(placed.shape) == x.shape
    jx = jax.device_put(x, jax_mesh.replicated_sharding(
        jax_mesh.make_mesh(devices=jax.devices()[:4])))
    for shard, js in zip(placed.shards, jx.addressable_shards):
        np.testing.assert_array_equal(shard.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(placed.gather().numpy(), x)


def test_an_uneven_batch_is_refused_as_jax_refuses_it():
    x = _batch(6)
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_batch(x, make_mesh(devices=[CPU] * 4))
    with pytest.raises(ValueError):
        jax_mesh.shard_batch(x, jax_mesh.make_mesh(devices=jax.devices()[:4]))


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_engine_pads_places_and_unpads_as_jaxs(k, tmp_path):
    x = _batch(5, seed=k)
    ours = Engine(mesh=make_mesh(devices=[CPU] * k) if k > 1 else None, use_mesh=False,
                  device="cpu")
    theirs = jax_engine.Engine(mesh=jax_mesh.make_mesh(devices=jax.devices()[:k])
                               if k > 1 else None, use_mesh=False)
    bo, bt = ours.batch_from_array(x), theirs.batch_from_array(x)
    assert isinstance(bo, Batch)
    assert (bo.padded_size, bo.n_valid, bo.paths) == (bt.padded_size, bt.n_valid, bt.paths)
    got = bo.x.gather() if isinstance(bo.x, ShardedTensor) else bo.x
    np.testing.assert_array_equal(got.numpy(), np.asarray(bt.x))
    y = np.arange(bo.padded_size * 2, dtype=np.float32).reshape(bo.padded_size, 2)
    np.testing.assert_array_equal(ours.unpad(torch.from_numpy(y), bo), theirs.unpad(y, bt))
    if k > 1:
        np.testing.assert_array_equal(ours.unpad(shard_batch(y, ours.mesh), bo),
                                      theirs.unpad(y, bt))


def test_engine_batches_a_directory_as_jaxs(tmp_path):
    rs = np.random.RandomState(3)
    for i in range(3):
        Image.fromarray((rs.rand(40, 30, 3) * 255).astype(np.uint8)).save(tmp_path / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    ours = Engine(use_mesh=False, device="cpu").batch_from_dir(tmp_path, size=32)
    theirs = jax_engine.Engine(use_mesh=False).batch_from_dir(tmp_path, size=32)
    assert ours.paths == theirs.paths and ours.n_valid == theirs.n_valid == 3
    np.testing.assert_array_equal(ours.x.numpy(), np.asarray(theirs.x))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no images found"):
        Engine(use_mesh=False, device="cpu").batch_from_dir(tmp_path / "empty")


def test_engine_makes_no_mesh_on_one_device_and_needs_cuda_by_default(monkeypatch):
    eng = Engine(device="cpu")
    assert eng.mesh is None and eng.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
