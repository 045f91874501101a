"""The port's native image loader (utils/native_loader.py, csrc/image_loader.cc)
and the ``ADV_TPU_NATIVE_LOADER`` toggle of its batch loaders, against the JAX
package's binding of the same C++ source on the CPU."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_recognition_adversarial_example_attack_tpu.core import images as jax_images
from image_recognition_adversarial_example_attack_tpu.utils import native_loader as jax_native
from image_recognition_adversarial_example_attack_tpu_torch.core import images
from image_recognition_adversarial_example_attack_tpu_torch.utils import native_loader
from image_recognition_adversarial_example_attack_tpu_torch.utils.pipeline import (
    EvalBatchPipeline)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """JPEGs of odd sizes, PNGs (RGB, RGBA, palette, gray) and a BMP."""
    d = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    out = {}
    for i, (w, h) in enumerate([(400, 300), (301, 403), (256, 256)]):
        out[f"jpg{i}"] = d / f"img_{i}.jpg"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(out[f"jpg{i}"],
                                                                         quality=92)
    arr = (rng.rand(300, 400, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(d / "rgb.png")
    Image.fromarray((rng.rand(403, 301, 4) * 255).astype(np.uint8), "RGBA").save(d / "rgba.png")
    Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE).save(d / "pal.png")
    Image.fromarray(arr).convert("L").save(d / "gray.png")
    Image.fromarray(arr).save(d / "img.bmp")
    for name in ("rgb.png", "rgba.png", "pal.png", "gray.png", "img.bmp"):
        out[name] = d / name
    out["corrupt"] = d / "corrupt.jpg"
    out["corrupt"].write_bytes(b"not an image at all")
    out["gif"] = d / "img.gif"  # readable by PIL, not by the C side
    Image.fromarray(arr).save(out["gif"])
    return out


def test_the_source_is_a_byte_copy_of_the_jax_packages():
    port = REPO / "image_recognition_adversarial_example_attack_tpu_torch/csrc/image_loader.cc"
    assert port.read_bytes() == (REPO / "native/loader.cc").read_bytes()


@pytest.mark.parametrize("names", [("jpg0", "jpg1", "jpg2"),
                                   ("rgb.png", "rgba.png", "pal.png", "gray.png"),
                                   ("img.bmp",)], ids=["jpeg", "png", "bmp"])
def test_native_decode_is_bit_equal_to_jaxs(files, names):
    paths = [files[n] for n in names]
    out, ok = native_loader.load_batch_native_with_status(paths)
    want, want_ok = jax_native.load_batch_native_with_status(paths)
    np.testing.assert_array_equal(ok, 1)
    np.testing.assert_array_equal(want_ok, 1)
    np.testing.assert_array_equal(out, want)
    # and within one uint8 quantum of PIL (JAX core/images.py:97)
    pil = np.concatenate([images.load_image(p) for p in paths])
    assert np.abs(out - pil).max() <= 1.0 / 255.0 + 1e-6


def test_native_decode_at_another_size_and_thread_count(files):
    paths = [files["jpg0"], files["rgb.png"]]
    out, _ = native_loader.load_batch_native_with_status(paths, size=64, n_threads=1)
    want, _ = jax_native.load_batch_native_with_status(paths, size=64, n_threads=3)
    assert out.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(out, want)


def test_undecodable_rows_are_flagged_and_decoded_again_with_pil(files):
    paths = [files["corrupt"], files["gif"], files["jpg0"]]
    _, ok = native_loader.load_batch_native_with_status(paths)
    assert list(ok) == [0, 0, 1]
    # the GIF is PIL's to decode; the corrupt file raises as PIL's error
    got = native_loader.load_image_batch_native(paths[1:])
    np.testing.assert_array_equal(got[0], images.load_image(files["gif"])[0])
    with pytest.raises(Exception):
        native_loader.load_image_batch_native(paths)


@pytest.mark.parametrize("value,on", [("1", True), ("on", True), ("true", True),
                                      ("0", False), ("off", False), ("false", False),
                                      ("TRUE", False), ("yes", False), ("", False)])
def test_the_toggle_whitelist_is_the_jax_packages(files, monkeypatch, value, on):
    monkeypatch.setenv("ADV_TPU_NATIVE_LOADER", value)
    assert images.native_loader_enabled() is on
    paths = [files["jpg1"]]
    got = images.load_image_batch(paths)
    np.testing.assert_array_equal(got, jax_images.load_image_batch(paths))
    pil = images.load_image(files["jpg1"])
    assert np.array_equal(got, pil) is not on  # this JPEG decodes differently


def test_the_toggle_gives_the_native_decoders_pixels(files, monkeypatch):
    """The repaired fault: with the toggle set, the port's loaders (and the
    streaming pipeline through them) return the native decoder's pixels, not
    PIL's, on images where the two differ."""
    paths = [files["jpg0"], files["jpg1"], files["rgb.png"]]
    native, _ = jax_native.load_batch_native_with_status(paths)
    pil = np.concatenate([images.load_image(p) for p in paths])
    assert not np.array_equal(native, pil)
    monkeypatch.setenv("ADV_TPU_NATIVE_LOADER", "1")
    x, kept = images.load_image_batch_tolerant(paths)
    np.testing.assert_array_equal(x, native)
    assert kept == [Path(p) for p in paths]
    np.testing.assert_array_equal(images.load_image_batch(paths), native)
    (step, chunk, _, n_valid), = list(EvalBatchPipeline(paths, 4))
    assert (step, n_valid) == (0, 3)
    np.testing.assert_array_equal(chunk[:3], native)


def test_the_loaders_under_the_toggle_equal_jaxs(files, monkeypatch, capsys):
    monkeypatch.setenv("ADV_TPU_NATIVE_LOADER", "on")
    paths = [files["jpg2"], files["corrupt"], files["gif"], files["img.bmp"]]
    x, kept = images.load_image_batch_tolerant(paths)
    want, want_kept = jax_images.load_image_batch_tolerant(paths)
    np.testing.assert_array_equal(x, want)
    assert kept == want_kept and len(kept) == 3
    assert "skipping unreadable image" in capsys.readouterr().err
    good = [p for p in paths if p != files["corrupt"]]
    np.testing.assert_array_equal(images.load_image_batch(good),
                                  jax_images.load_image_batch(good))


def test_a_failed_build_raises(files, monkeypatch):
    """Where the toggle is set and the loader cannot be built, the port
    raises with the compiler's failure; the JAX binding would switch to PIL
    in silence."""
    monkeypatch.setenv("CXX", "false")
    assert not native_loader.native_available()
    monkeypatch.setenv("ADV_TPU_NATIVE_LOADER", "1")
    with pytest.raises(RuntimeError, match="native image loader"):
        images.load_image_batch_tolerant([files["jpg0"]])
    with pytest.raises(RuntimeError, match="native image loader"):
        images.load_image_batch([files["jpg0"]])
    monkeypatch.delenv("ADV_TPU_NATIVE_LOADER")
    images.load_image_batch([files["jpg0"]])  # the toggle off never builds


def test_the_library_lives_in_the_build_directory():
    lib = native_loader.load_library()
    assert lib.loader_abi_version() == native_loader.ABI_VERSION == 2
    built = [p for p in native_loader._build.BUILD_DIR.glob("libimage_loader_*.so")]
    assert built and not list((REPO / "native").glob("libimage_loader*"))

