"""Streaming input pipeline: decode the next chunk while the device runs
(port of ``_ThreadedPipeline`` and ``EvalBatchPipeline`` of
``utils/pipeline.py``).

A background thread decodes and preprocesses chunk t+1 (PIL, releasing the
interpreter lock in its C code) while the card works on chunk t; the host
work hides behind the device step whenever decoding a chunk takes less time
than evaluating it.

- Static chunk shape: the tail chunk is padded by repeating decoded rows,
  with ``n_valid`` marking the real prefix, so every chunk runs the same
  shapes.
- A bounded queue (depth 2): decoding runs at most one chunk ahead, so host
  memory stays constant and the producer waits for the consumer.
- Per-image failure isolation: unreadable files are skipped with a warning
  (``core.images.load_image_batch_tolerant``); a chunk is dropped only if
  every image in it is unreadable.

The training pipeline (``BatchPipeline``, ``shuffle_seed``) comes with the
training slice of the port.
"""

from __future__ import annotations

import queue
import sys
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..core.constants import IMAGE_SIZE
from ..core.images import load_image_batch_tolerant


class _ThreadedPipeline:
    """Producer/consumer spine: a daemon thread fills a bounded queue;
    iteration drains it and reaps the thread on every exit path."""

    def __init__(self, prefetch: int) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(prefetch)))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _produce(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def _put(self, item) -> bool:
        """``put`` that gives up once the consumer has stopped: an abandoned
        iteration must not leave the producer blocked on a full queue."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator:
        if self._thread is not None:
            raise RuntimeError(f"{type(self).__name__} is single-use; build a new one")
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # normal exit, an exception in the consumer, or close(): stop the
            # producer and reap the thread either way
            self._stop.set()
            self._thread.join(timeout=30.0)


class EvalBatchPipeline(_ThreadedPipeline):
    """Ordered single-pass chunks for evaluation at constant memory.

    Iterates ``(step, x [C,H,W,3] float32, y [C] int32 | None, n_valid)``
    over ``paths`` in order, each image exactly once, with background
    decode.  The tail chunk is padded to the static shape by repeating
    decoded rows; the consumer masks every counter past ``n_valid``.  Decode
    failures shrink ``n_valid``; a chunk whose images are all unreadable is
    skipped with a warning, and ``step`` counts the chunks yielded.
    ``labels`` (optional) ride along with the kept images.
    """

    def __init__(self, paths: Sequence[str | Path], chunk_size: int, *,
                 labels: Sequence[int] | None = None, size: int = IMAGE_SIZE,
                 prefetch: int = 2) -> None:
        if not paths:
            raise ValueError("empty dataset")
        if labels is not None and len(labels) != len(paths):
            raise ValueError(f"{len(paths)} paths vs {len(labels)} labels")
        super().__init__(prefetch)
        self._paths = [str(p) for p in paths]
        self._labels = None if labels is None else np.asarray(labels, np.int32)
        self._chunk = int(chunk_size)
        self._size = int(size)

    @property
    def n_chunks(self) -> int:
        return -(-len(self._paths) // self._chunk)

    def _produce(self) -> None:
        try:
            step = 0
            for start in range(0, len(self._paths), self._chunk):
                chunk_paths = self._paths[start:start + self._chunk]
                try:
                    x, kept = load_image_batch_tolerant(chunk_paths, size=self._size)
                except ValueError:
                    # every image of the chunk unreadable: drop the chunk;
                    # later chunks still evaluate
                    print(f"warning: skipping chunk at offset {start} — "
                          "no readable images", file=sys.stderr)
                    continue
                kept_set = {str(Path(p)) for p in kept}
                keep_idx = [start + i for i, p in enumerate(chunk_paths)
                            if str(Path(p)) in kept_set]
                n_valid = x.shape[0]
                y = None if self._labels is None else self._labels[keep_idx]
                if n_valid < self._chunk:
                    reps = np.resize(np.arange(n_valid), self._chunk - n_valid)
                    x = np.concatenate([x, x[reps]], axis=0)
                    if y is not None:
                        y = np.concatenate([y, y[reps]], axis=0)
                if not self._put((step, x, y, n_valid)):
                    return  # the consumer abandoned the iteration
                step += 1
            self._put(None)  # end of stream
        except BaseException as e:  # surface a producer crash to the consumer
            self._put(e)
