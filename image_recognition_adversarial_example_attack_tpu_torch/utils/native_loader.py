"""ctypes binding of the threaded C++ image loader (port of
``utils/native_loader.py``).

The loader's source is the package's own copy, ``csrc/image_loader.cc``
(byte-equal to the JAX package's ``native/loader.cc``): threaded JPEG, PNG and
BMP decode, PIL's antialiased bilinear resize, center crop, float32 NHWC in
[0, 1], within 1/255 of the PIL path.  It is compiled at first use with

    $CXX -O3 -march=native -fPIC -std=c++17 -shared image_loader.cc
        -ljpeg [-lpng] -lpthread

(``CXX`` defaults to ``g++``; libpng is linked only where ``<png.h>``
preprocesses, as the JAX package's ``native/Makefile`` does) into the
directory the CUDA libraries are built in (``kernels/build.py``).  The file's
name carries a hash of the source, the compiler, the flags and what
``-march=native`` resolves to on this host, so a checkout shared between
hosts never loads another CPU's build.

Rows the C side flags ``ok == 0`` (an unknown format, a corrupt file) are
decoded again with PIL, one image at a time, as the JAX binding does.  Unlike
the JAX binding, which falls back to PIL in silence when the library cannot
be built, a failed build raises ``RuntimeError`` with the compiler's output:
the caller asked for this decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from ..core.constants import IMAGE_SIZE, RESIZE_SIZE
from ..kernels import build as _build

SOURCE = _build.CSRC_DIR / "image_loader.cc"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
ABI_VERSION = 2  # v2 adds PNG and BMP decode (image_loader.cc:390)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}  # compiler -> its loaded build


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _run(cmd: list[str], stdin: str = "") -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=300)
    except OSError as e:  # the compiler itself is missing
        raise RuntimeError(f"the native image loader cannot be built: {shlex.join(cmd)}: "
                           f"{e}") from e


def _native_target(cxx: str) -> str:
    """The target flags ``-march=native`` resolves to on this host."""
    proc = _run([cxx, "-march=native", "-###", "-E", "-x", "c++", "-"])
    cc1 = [ln for ln in proc.stderr.splitlines() if "cc1" in ln]
    if proc.returncode != 0 or not cc1:
        raise RuntimeError(f"the native image loader cannot be built: {cxx} does not "
                           f"resolve -march=native (exit {proc.returncode}):\n{proc.stderr}")
    return " ".join(t for t in shlex.split(cc1[0]) if t.startswith("-m"))


def _libs(cxx: str) -> list[str]:
    """-ljpeg, -lpng where ``<png.h>`` preprocesses, -lpthread."""
    png = _run([cxx, "-E", "-x", "c++", "-"], stdin="#include <png.h>\n").returncode == 0
    return ["-ljpeg", *(["-lpng"] if png else []), "-lpthread"]


def library_path(cxx: str, libs: list[str]) -> Path:
    key = b"\0".join([SOURCE.read_bytes(), cxx.encode(), " ".join(CXX_FLAGS).encode(),
                      " ".join(libs).encode(), _native_target(cxx).encode()])
    return _build.BUILD_DIR / f"libimage_loader_{hashlib.sha256(key).hexdigest()[:12]}.so"


def _build_library(cxx: str, libs: list[str], out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *libs]
        proc = _run(cmd)
        if proc.returncode != 0:
            raise RuntimeError(f"the native image loader failed to build (exit "
                               f"{proc.returncode}): {shlex.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    finally:
        Path(tmp).unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Build (at first use on this host) and load the loader; raises
    ``RuntimeError`` where it cannot be built or its ABI is not version 2."""
    cxx = _compiler()
    with _lock:
        if cxx not in _libraries:
            libs = _libs(cxx)
            path = library_path(cxx, libs)
            if not path.is_file():
                _build_library(cxx, libs, path)
            lib = ctypes.CDLL(str(path))
            lib.load_batch.restype = ctypes.c_int
            lib.load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
            lib.loader_abi_version.restype = ctypes.c_int
            lib.loader_abi_version.argtypes = []
            version = lib.loader_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{path.name}: loader ABI {version}, want {ABI_VERSION}")
            _libraries[cxx] = lib
        return _libraries[cxx]


def native_available() -> bool:
    """Whether the loader builds and loads on this host."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def load_batch_native_with_status(
    paths: Sequence[str | Path],
    size: int = IMAGE_SIZE,
    resize_to: int | None = None,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Raw native decode: ([B, size, size, 3] float32, ok [B] int32).

    ``ok[i] == 0`` rows were not decoded (an unknown format, a corrupt
    file) and hold garbage: callers decode them otherwise or drop them.
    ``n_threads`` 0 takes one thread per hardware thread."""
    n = len(paths)
    if n == 0:
        raise ValueError("empty path list")
    if resize_to is None:
        # the resize edge scales with the crop, as core.images.load_image's
        resize_to = max(size, round(size * RESIZE_SIZE / IMAGE_SIZE))
    lib = load_library()
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.load_batch(c_paths, n, int(resize_to), int(size), int(n_threads),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, ok


def load_image_batch_native(
    paths: Sequence[str | Path],
    size: int = IMAGE_SIZE,
    resize_to: int | None = None,
    n_threads: int = 0,
) -> np.ndarray:
    """[B, size, size, 3] float32 in [0,1]; each row the C side could not
    decode is decoded with PIL (which raises where the file is unreadable)."""
    out, ok = load_batch_native_with_status(paths, size=size, resize_to=resize_to,
                                            n_threads=n_threads)
    if not np.all(ok == 1):
        from ..core.images import load_image

        for i in np.nonzero(ok == 0)[0]:
            out[i] = load_image(paths[i], size=size)[0]
    return out
