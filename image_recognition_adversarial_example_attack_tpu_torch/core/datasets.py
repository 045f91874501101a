"""The ImageNet validation set's ground truth (port of the ImageNet part of
``core/datasets.py``; CIFAR-10 is not ported yet).

A copy of the JAX package's ``list_imagenet_val`` and
``_val_from_annotations``: the port imports nothing of that package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .constants import IMAGE_EXTS

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
