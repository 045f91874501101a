"""Dataset readers (port of ``core/datasets.py``): the standard CIFAR-10
archives and the ImageNet validation set's ground truth.

Copies of the JAX package's functions: the port imports nothing of that
package.  No torchvision is needed: the CIFAR-10 formats are plain pickle
and raw bytes.  Layouts under ``root``, detected in this order:

- ``cifar-10-batches-py/`` (or the files directly in ``root``): python
  pickles ``data_batch_1..5`` + ``test_batch``, each ``{b"data": uint8
  [N,3072] channel-planar rows, b"labels": [N]}`` (str keys are read too);
- ``cifar-10-batches-bin/`` (or the files directly in ``root``): records of
  one label byte and 3072 pixel bytes (``data_batch_N.bin`` /
  ``test_batch.bin``).

Images come back NHWC float32 in [0,1], the framework's image convention
(normalization happens inside the logits function), and labels int32.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .constants import IMAGE_EXTS

CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)

_PY_DIR = "cifar-10-batches-py"
_BIN_DIR = "cifar-10-batches-bin"


def _find_dir(root: Path, sub: str, markers: tuple[str, ...]) -> Path | None:
    for cand in (root / sub, root):
        if any((cand / m).is_file() for m in markers):
            return cand
    return None


def _decode_rows(rows: np.ndarray) -> np.ndarray:
    """uint8 [N, 3072] channel-planar rows -> float32 [N, 32, 32, 3]."""
    x = rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x, dtype=np.float32) / 255.0


def _load_pickle_batch(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")

    def get(key: str):
        # the official archives pickle with bytes keys; str keys are read too
        return d[key.encode()] if key.encode() in d else d[key]

    data = np.asarray(get("data"), np.uint8)
    return _decode_rows(data), np.asarray(get("labels"), np.int32)


def _load_bin_batch(path: Path) -> tuple[np.ndarray, np.ndarray]:
    raw = np.frombuffer(path.read_bytes(), np.uint8)
    if raw.size % 3073:
        raise ValueError(f"{path}: size {raw.size} is not a multiple of "
                         "3073 (1 label byte + 3072 pixels per record)")
    rec = raw.reshape(-1, 3073)
    return _decode_rows(rec[:, 1:].copy()), rec[:, 0].astype(np.int32)


def load_cifar10(root: str | Path, split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 from the standard archives under ``root``: ``split`` is
    ``"train"`` (data_batch_1..5, those present) or ``"test"``
    (test_batch).  Returns ``(x [N,32,32,3] float32 in [0,1], y [N]
    int32)``; raises ValueError for another split and FileNotFoundError
    where no archive or no batch of the split is found."""
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    root = Path(root)
    for sub, suffix, load in ((_PY_DIR, "", _load_pickle_batch),
                              (_BIN_DIR, ".bin", _load_bin_batch)):
        found = _find_dir(root, sub, (f"data_batch_1{suffix}", f"test_batch{suffix}"))
        if found is None:
            continue
        names = ([f"data_batch_{i}{suffix}" for i in range(1, 6)]
                 if split == "train" else [f"test_batch{suffix}"])
        present = [found / n for n in names if (found / n).is_file()]
        if not present:
            what = f"{suffix} batches" if suffix else "batches"
            raise FileNotFoundError(f"no {split} {what} under {found}")
        parts = [load(p) for p in present]
        return np.concatenate([x for x, _ in parts]), np.concatenate([y for _, y in parts])
    raise FileNotFoundError(
        f"no CIFAR-10 archive found under {root} (looked for "
        f"{_PY_DIR}/data_batch_1 and {_BIN_DIR}/data_batch_1.bin)")


_VAL_MAP_NAMES = ("val_map.txt", "val_annotations.txt")


def list_imagenet_val(
    val_dir: str | Path,
) -> tuple[list[Path], np.ndarray, list[str] | None]:
    """Paths + ground-truth labels from an ImageNet-val directory.

    Two on-disk layouts, detected in this order:

    - **annotation file** ``val_map.txt`` (or ``val_annotations.txt``):
      whitespace-separated lines ``<filename> <label>`` where label is
      either an integer class index or a class-name string such as a WNID
      (indices are then positions in the SORTED unique-name list); extra
      columns are ignored.  Images may sit next to the file OR in an
      ``images/`` subdirectory (the tiny-imagenet layout).  The file wins
      over subfolder detection: the tiny-imagenet tree has both, and
      treating ``images/`` as a class folder would label everything 0.
    - **class subfolders** (torchvision ``ImageFolder``):
      ``val_dir/<class>/*.JPEG``.  Class index = position of the folder
      name in the SORTED folder list, torchvision's convention, so WNID
      folders line up with a converted torchvision checkpoint.

    Returns ``(paths sorted, labels int64 [N], class_names or None)``
    (class names for the subfolder and named-annotation layouts).  An
    image with no label is an error: this entry point exists to guarantee
    ground truth.
    """
    exts = tuple(IMAGE_EXTS)
    root = Path(val_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"imagenet_val_dir not found: {root}")

    for name in _VAL_MAP_NAMES:
        map_file = root / name
        if map_file.is_file():
            return _val_from_annotations(root, map_file, exts)

    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if classes:
        idx = {c: i for i, c in enumerate(classes)}
        pairs: list[tuple[Path, int]] = []
        for c in classes:
            for p in sorted((root / c).iterdir()):
                if p.is_file() and p.suffix.lower() in exts:
                    pairs.append((p, idx[c]))
        if not pairs:
            raise FileNotFoundError(
                f"{root}: {len(classes)} class folders but no images with "
                f"extensions {exts}")
        paths = [p for p, _ in pairs]
        labels = np.asarray([l for _, l in pairs], np.int64)
        return paths, labels, classes

    raise FileNotFoundError(
        f"{root}: neither class subfolders nor a "
        f"{'/'.join(_VAL_MAP_NAMES)} annotation file found")


def _val_from_annotations(root: Path, map_file: Path, exts) -> tuple:
    raw: dict[str, str] = {}
    for ln, line in enumerate(map_file.read_text().splitlines(), 1):
        parts = line.split()
        if not parts:
            continue
        if len(parts) < 2:
            raise ValueError(
                f"{map_file}:{ln}: expected '<filename> "
                f"<label>', got {line!r}")
        raw[parts[0]] = parts[1]

    def _is_int(v: str) -> bool:
        try:
            int(v)
            return True
        except ValueError:
            return False

    int_like = [_is_int(v) for v in raw.values()]
    class_names: list[str] | None = None
    if all(int_like):
        table = {k: int(v) for k, v in raw.items()}
    elif not any(int_like):
        # WNID column: sorted unique names -> indices (the subfolder
        # convention applied to annotation labels)
        class_names = sorted(set(raw.values()))
        idx = {c: i for i, c in enumerate(class_names)}
        table = {k: idx[v] for k, v in raw.items()}
    else:
        raise ValueError(
            f"{map_file}: labels mix integer class indices and class-name "
            f"strings — ground-truth mode needs one convention")
    scan_dirs = [root]
    if (root / "images").is_dir():  # tiny-imagenet: val/images/*.JPEG
        scan_dirs.append(root / "images")
    paths = sorted(p for d in scan_dirs for p in d.iterdir()
                   if p.is_file() and p.suffix.lower() in exts)
    if not paths:
        raise FileNotFoundError(f"{root}: no images next to {map_file.name}")
    missing = [p.name for p in paths if p.name not in table]
    if missing:
        raise ValueError(
            f"{map_file}: no entry for {len(missing)} image(s) "
            f"({missing[:3]}{'...' if len(missing) > 3 else ''}) — "
            f"ground-truth mode requires every image labeled")
    labels = np.asarray([table[p.name] for p in paths], np.int64)
    return paths, labels, class_names
