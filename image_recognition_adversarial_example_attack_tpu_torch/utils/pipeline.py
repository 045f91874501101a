"""Streaming input pipeline: decode the next batch while the device runs
(port of ``shuffle_seed``, ``_ThreadedPipeline``, ``BatchPipeline`` and
``EvalBatchPipeline`` of ``utils/pipeline.py``).

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

``BatchPipeline`` (training) reshuffles each epoch with
``RandomState(shuffle_seed(seed, epoch))``, the order of the training CLI's
in-RAM path, and refills a short tail batch from the same epoch and the
rows of failed decodes by repeating decoded ones, so every batch has the
same shape.  ``EvalBatchPipeline`` (evaluation) keeps the listed order,
each image once.
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


def shuffle_seed(seed: int, epoch: int) -> int:
    """The epoch-shuffle seed, ``(seed * 100003 + epoch) mod 2**32``: it
    depends on ``--seed`` and on the epoch alone, so a resumed run replays
    the order an uninterrupted run would have used.  The training CLI's
    in-RAM path and ``BatchPipeline`` share it."""
    return (int(seed) * 100003 + int(epoch)) % (2 ** 32)


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


class BatchPipeline(_ThreadedPipeline):
    """Iterate ``(epoch, step, x [B,H,W,3] float32, y [B] int32)`` over
    epochs ``start_epoch .. epochs-1`` with background decode.

    ``paths`` / ``labels`` are the whole dataset.  Each epoch reshuffles
    with ``RandomState(shuffle_seed(seed, epoch))`` and yields
    ``len(paths) // batch_size`` batches (at least one); a short last batch
    is filled from the start of the epoch's order, and the rows of images
    that fail to decode by repeating decoded rows.  An exception in the
    producer is raised in the consumer.
    """

    def __init__(self, paths: Sequence[str | Path], labels: Sequence[int], batch_size: int, *,
                 size: int = IMAGE_SIZE, epochs: int = 1, start_epoch: int = 0,
                 prefetch: int = 2, seed: int = 0) -> None:
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} paths vs {len(labels)} labels")
        if not paths:
            raise ValueError("empty dataset")
        super().__init__(prefetch)
        self._paths = [str(p) for p in paths]
        self._labels = np.asarray(labels, np.int32)
        self._batch = int(batch_size)
        self._size = int(size)
        self._epochs = int(epochs)
        self._start_epoch = int(start_epoch)
        self._seed = int(seed)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, len(self._paths) // self._batch)

    def _produce(self) -> None:
        try:
            for epoch in range(self._start_epoch, self._epochs):
                order = np.random.RandomState(
                    shuffle_seed(self._seed, epoch)).permutation(len(self._paths))
                for s in range(self.steps_per_epoch):
                    idx = order[s * self._batch:(s + 1) * self._batch]
                    if len(idx) < self._batch:  # the static shape: resample
                        idx = np.concatenate([idx, order[: self._batch - len(idx)]])
                    batch_paths = [self._paths[i] for i in idx]
                    x, kept = load_image_batch_tolerant(batch_paths, size=self._size)
                    # both sides Path-normalized ("./a.jpg" is "a.jpg")
                    kept_set = {str(Path(p)) for p in kept}
                    y = np.asarray([self._labels[i] for i, p in zip(idx, batch_paths)
                                    if str(Path(p)) in kept_set], np.int32)
                    if x.shape[0] < self._batch:
                        # refill the rows of failed decodes by repeating
                        # decoded ones
                        reps = np.resize(np.arange(x.shape[0]), self._batch - x.shape[0])
                        x = np.concatenate([x, x[reps]], axis=0)
                        y = np.concatenate([y, y[reps]], axis=0)
                    if not self._put((epoch, s, x, y)):
                        return  # the consumer abandoned the iteration
            self._put(None)  # end of stream
        except BaseException as e:  # surface a producer crash to the consumer
            self._put(e)


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
