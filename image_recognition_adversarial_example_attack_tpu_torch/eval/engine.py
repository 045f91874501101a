"""Batch execution engine: images -> a padded batch on the device or the
mesh (port of ``eval/engine.py``).

A directory of images becomes one ``[B, H, W, 3]`` batch, padded up to a
multiple of the mesh's data-axis size by repeating its last image, and
placed on the device, or split over the mesh when there is one; results are
sliced back to the valid count.  As in the JAX package, a mesh is made only
when more than one device is visible; the device is ``cuda`` unless the
caller asks for ``cpu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device, to_device
from ..core.images import list_images, load_image_batch, pad_batch
from ..parallel.mesh import Mesh, ShardedTensor, data_sharding, make_mesh, visible_devices


@dataclass
class Batch:
    """A device-resident image batch plus bookkeeping."""

    x: torch.Tensor | ShardedTensor  # [B_padded, H, W, 3] float32 in [0,1]
    paths: list[Path]                # length n_valid
    n_valid: int

    @property
    def padded_size(self) -> int:
        return self.x.shape[0]


class Engine:
    """Owns the mesh (or the one device) and moves batches onto it."""

    def __init__(self, mesh: Mesh | None = None, use_mesh: bool = True,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if mesh is None and use_mesh:
            devices = visible_devices(self.device)
            if len(devices) > 1:
                mesh = make_mesh(devices=devices)
        self.mesh = mesh

    def batch_from_paths(self, paths: Sequence[str | Path], size: int = 224) -> Batch:
        x_np = load_image_batch(paths, size=size)
        return self.batch_from_array(x_np, paths=[Path(p) for p in paths])

    def batch_from_dir(self, image_dir: str | Path, size: int = 224) -> Batch:
        paths = list_images(image_dir)
        if not paths:
            raise FileNotFoundError(f"no images found in {image_dir}")
        return self.batch_from_paths(paths, size=size)

    def batch_from_array(self, x_np: np.ndarray, paths: list[Path] | None = None) -> Batch:
        multiple = self.mesh.shape["data"] if self.mesh is not None else 1
        x_pad, n_valid = pad_batch(np.asarray(x_np, np.float32), multiple)
        if self.mesh is not None:
            x = data_sharding(self.mesh).place(x_pad)
        else:
            x = to_device(torch.from_numpy(np.ascontiguousarray(x_pad)), self.device)
        return Batch(x=x, paths=paths or [], n_valid=n_valid)

    def unpad(self, arr, batch: Batch) -> np.ndarray:
        """Slice a [B_padded, ...] result back to the valid prefix (host)."""
        if isinstance(arr, ShardedTensor):
            arr = arr.gather()
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        return np.asarray(arr)[: batch.n_valid]
