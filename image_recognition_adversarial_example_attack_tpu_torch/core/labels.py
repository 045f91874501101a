"""ImageNet class-name lookup (port of ``core/labels.py``).

The same search order as the JAX package: ``$IMAGENET_CLASSES`` ->
``imagenet_classes.txt`` in the working directory -> the packaged data file
-> the ``class_{i}`` fallback.  No data file is packaged, so without the
first two the fallback names are what a run prints.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path

from .constants import NUM_CLASSES

_DATA_FILE = Path(__file__).resolve().parent.parent / "data" / "imagenet_classes.txt"


@lru_cache(maxsize=1)
def load_imagenet_labels() -> list[str]:
    candidates = []
    env = os.environ.get("IMAGENET_CLASSES")
    if env:
        candidates.append(Path(env))
    candidates.append(Path("imagenet_classes.txt"))
    candidates.append(_DATA_FILE)
    for path in candidates:
        try:
            if path.is_file():
                lines = [ln.strip() for ln in path.read_text(encoding="utf-8").splitlines()]
                lines = [ln for ln in lines if ln]
                if len(lines) >= NUM_CLASSES:
                    return lines[:NUM_CLASSES]
        except OSError:
            continue
    return [f"class_{i}" for i in range(NUM_CLASSES)]

