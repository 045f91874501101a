"""Builds the hand-written CUDA kernels with nvcc and loads them with ctypes.

Each source under ``csrc/`` has a plain C interface and becomes a shared
library of its own, built by ``nvcc`` in seconds without PyTorch's headers
and loaded with its own signature table (``SIGNATURES``).  The build happens
at first use, on the machine with the card, into ``build/torch_kernels/`` of
the checkout, or, for an installed package, into a per-user cache directory;
the library's file name carries a hash of its source and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is.  ``build_all``
starts one nvcc per source at once and waits for them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"


def default_build_dir(package_dir: Path = PACKAGE_DIR) -> Path:
    """``build/torch_kernels/`` of the checkout when the package sits in a
    source tree (``pyproject.toml`` beside it); else
    ``$XDG_CACHE_HOME/<package>/torch_kernels`` (default ``~/.cache``), since an
    installed package's directory is shared and often read-only."""
    root = package_dir.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_kernels"
    cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
    return cache / package_dir.name / "torch_kernels"


BUILD_DIR = default_build_dir()

# No --use_fast_math: the quantize kernel needs IEEE division and rintf, and
# the conv kernels exact float32 sums.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# name -> (restype, argtypes) of each extern "C" launcher in csrc/elementwise.cu
ELEMENTWISE_SIGNATURES = {
    "pgd_step_launch": (ctypes.c_int, [_P, _P, _P, _P, ctypes.c_longlong,
                                       ctypes.c_float, ctypes.c_float, _P]),
    "quantize_launch": (ctypes.c_int, [_P, _P, ctypes.c_longlong,
                                       ctypes.c_float, _P]),
    "uniform_noise_launch": (ctypes.c_int, [_P, ctypes.c_longlong,
                                            ctypes.c_ulonglong,
                                            ctypes.c_float, ctypes.c_longlong, _P]),
}
# the extern "C" launchers of csrc/conv3x3.cu: (x, w, out, batch, h, w, then
# the tile plan's rows and buf_rows, an int[4] for the grid, stream)
CONV3X3_SIGNATURES = {
    f"conv3x3_{t}_launch": (ctypes.c_int, [_P, _P, _P, *[ctypes.c_int] * 5,
                                           ctypes.POINTER(ctypes.c_int), _P])
    for t in ("bf16", "f32")
}
# source stem under csrc/ -> its signature table
SIGNATURES = {"elementwise": ELEMENTWISE_SIGNATURES, "conv3x3": CONV3X3_SIGNATURES}

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the PATH, or /usr/local/cuda; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def _start(source: Path) -> tuple[Path, str, subprocess.Popen] | None:
    """Start nvcc on ``source`` into a temporary file, unless its library exists."""
    out = library_path(source)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(find_nvcc(), source, Path(tmp)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(source: Path, started) -> tuple[Path, str]:
    if started is None:
        return library_path(source), ""
    out, tmp, proc = started
    try:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out, stdout + stderr


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` unless its library exists. Returns (path, nvcc log)."""
    return _finish(source, _start(source))


def build_all() -> dict[str, tuple[Path, str]]:
    """Build every source at once, one nvcc each; {name: (path, nvcc log)}."""
    sources = {n: CSRC_DIR / f"{n}.cu" for n in SIGNATURES}
    started, results, errors = {}, {}, []
    try:
        for n, src in sources.items():
            started[n] = _start(src)
    finally:  # every nvcc that started is waited for, whatever failed
        for n, s in started.items():
            try:
                results[n] = _finish(sources[n], s)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    return results


def load_library(name: str = "elementwise") -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``; declares every
    launcher's argtypes so ctypes never truncates a pointer."""
    with _lock:
        if name not in _libraries:
            path, _ = build(CSRC_DIR / f"{name}.cu")
            lib = ctypes.CDLL(str(path))
            for fn_name, (restype, argtypes) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = argtypes
            _libraries[name] = lib
        return _libraries[name]
