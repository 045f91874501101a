"""Host-side image IO and preprocessing (port of ``core/images.py``).

The PIL pipeline of the JAX package, copied: shorter side -> 256 with PIL
bilinear (antialiased, as torchvision does for PIL inputs) and torchvision's
int-truncation of the long side, a centered 224 crop with round() offsets,
scaled to [0,1].  Output is NHWC float32 numpy; callers move it to a device.

With ``ADV_TPU_NATIVE_LOADER`` set to ``1``, ``on`` or ``true`` (exactly
these, as in the JAX package), the batch loaders decode through the threaded
C++ loader (``utils/native_loader.py``), within 1/255 of PIL; PIL decodes
the rows the native decoder cannot.
"""

from __future__ import annotations

import io
import os
import sys
from pathlib import Path
from typing import Sequence

import numpy as np
from PIL import Image

from .constants import IMAGE_EXTS, IMAGE_SIZE, RESIZE_SIZE


def preprocess_pil(img: Image.Image, resize: int = RESIZE_SIZE,
                   crop: int = IMAGE_SIZE) -> np.ndarray:
    """PIL image -> [H, W, 3] float32 array in [0,1]."""
    img = img.convert("RGB")
    w, h = img.size
    # torchvision truncates the scaled long side with int(), not round()
    if w <= h:
        new_w, new_h = resize, max(1, int(h * resize / w))
    else:
        new_w, new_h = max(1, int(w * resize / h)), resize
    img = img.resize((new_w, new_h), Image.Resampling.BILINEAR)

    left = int(round((new_w - crop) / 2.0))
    top = int(round((new_h - crop) / 2.0))
    img = img.crop((left, top, left + crop, top + crop))

    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:  # grayscale safety; convert("RGB") should prevent this
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def _resize_for(size: int) -> int:
    """The resize edge for a given crop: 256/224 scaled, floor ``size``."""
    return max(size, round(size * RESIZE_SIZE / IMAGE_SIZE))


def load_image(path: str | Path, size: int = IMAGE_SIZE) -> np.ndarray:
    """Load one image -> [1, size, size, 3] float32 in [0,1] (NHWC)."""
    with Image.open(path) as img:
        arr = preprocess_pil(img, crop=size, resize=_resize_for(size))
    return arr[None]


def load_image_bytes(raw: bytes, size: int = IMAGE_SIZE) -> np.ndarray:
    """Encoded image bytes -> [size, size, 3] float32 in [0,1], with
    ``load_image``'s resize and crop at every size, so that serve's
    ``image_b64`` requests see the pixels a path request sees."""
    with Image.open(io.BytesIO(raw)) as img:
        return preprocess_pil(img, crop=size, resize=_resize_for(size))


def list_images(image_dir: str | Path) -> list[Path]:
    """Sorted image files in a directory (jpg/jpeg/png/bmp)."""
    return sorted(p for p in Path(image_dir).iterdir()
                  if p.is_file() and p.suffix.lower() in IMAGE_EXTS)


def native_loader_enabled() -> bool:
    """The ``ADV_TPU_NATIVE_LOADER`` toggle: on for ``1``, ``on`` or
    ``true`` only."""
    return os.environ.get("ADV_TPU_NATIVE_LOADER", "") in ("1", "on", "true")


def load_image_batch(paths: Sequence[str | Path], size: int = IMAGE_SIZE) -> np.ndarray:
    """Load many images into one [B, size, size, 3] float32 batch; raises on
    an unreadable file.  Under the toggle the native loader decodes it, and
    PIL each row it flags."""
    if not paths:
        raise ValueError("load_image_batch: empty path list")
    if native_loader_enabled():
        from ..utils.native_loader import load_image_batch_native

        return load_image_batch_native(paths, size=size)
    return np.concatenate([load_image(p, size=size) for p in paths], axis=0)


def load_image_batch_tolerant(paths: Sequence[str | Path],
                              size: int = IMAGE_SIZE
                              ) -> tuple[np.ndarray, list[Path]]:
    """Load many images into one [B, size, size, 3] batch, skipping
    unreadable files with a warning on stderr. Returns (batch, loaded paths).
    Under the toggle the native loader decodes the batch; PIL retries the
    rows it flags, and the files PIL cannot read either are skipped.
    """
    paths = list(paths)
    native_out = None
    ok = np.zeros((len(paths),), np.int32)  # the rows the native decoder filled
    if paths and native_loader_enabled():
        from ..utils.native_loader import load_batch_native_with_status

        native_out, ok = load_batch_native_with_status(paths, size=size)
    arrays: list[np.ndarray] = []
    good: list[Path] = []
    for i, p in enumerate(paths):
        if ok[i]:
            arrays.append(native_out[i][None])
            good.append(Path(p))
            continue
        try:
            arrays.append(load_image(p, size=size))
            good.append(Path(p))
        except Exception as e:  # noqa: BLE001 — isolate any decode failure
            print(f"WARNING: skipping unreadable image {p}: {e}",
                  file=sys.stderr)
    if not arrays:
        raise ValueError("no readable images in batch")
    return np.concatenate(arrays, axis=0), good


def pad_batch(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the batch dim up to a multiple of ``multiple`` by repeating the
    last image (for an even split over devices). Returns (padded, n_valid);
    callers slice results back to ``n_valid``."""
    n = x.shape[0]
    if multiple <= 1 or n % multiple == 0:
        return x, n
    pad = multiple - (n % multiple)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0), n


def save_image_01(x, path: str | Path) -> None:
    """Save a [H,W,3] or [1,H,W,3] array in [0,1] as PNG/JPEG, rounding to
    uint8 (<= 0.5/255 error, as torchvision's ToPILImage)."""
    arr = np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, 0.0, 1.0)
    arr8 = np.round(arr * 255.0).astype(np.uint8)
    path = Path(path)
    if path.parent and str(path.parent) not in ("", "."):
        path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr8).save(path)
