"""Builds the hand-written CUDA kernels with nvcc and loads them with ctypes.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` builds a
shared library in seconds without PyTorch's headers.  The build happens at
first use, on the machine with the card, into ``build/torch_kernels/`` of the
checkout, or, for an installed package, into a per-user cache directory; the
library's file name carries a hash of its source and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is.
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

# No --use_fast_math: the quantize kernel needs IEEE division and rintf.
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
                                            ctypes.c_float, _P]),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


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


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` unless its library exists. Returns (path, nvcc log)."""
    out = library_path(source)
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), source, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/elementwise.cu``; declares every
    launcher's argtypes so ctypes never truncates a pointer."""
    global _library
    with _lock:
        if _library is None:
            path, _ = build(CSRC_DIR / "elementwise.cu")
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in ELEMENTWISE_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _library = lib
        return _library
