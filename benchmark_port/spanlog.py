"""The program's own span log, as the per-layer readers of ``metrics/`` take it.

The port records its spans and counters while a profiler session records
(``utils/profiling.py``: ``spans()``, one dict per finished span with
``name``, ``id``, ``parent``, ``top``, host and device enter and exit in ns
on the host's clock, and ``counts``), so after the traced stretch the log
holds the stretch's spans and nothing else.  A program without that
recorder gives no log, and its readers return None.

Names of the log this file relies on: a unit's roots (``attack``, which
sits under ``defense.eval`` in the defense cell and under ``train.step`` in
training; ``train.step``), the passes (``model.forward``,
``model.backward``), the PGD step (``attack.step``), the defense cell's
stages (``defense.eval``, ``defense.defend``, ``detector.score``) and the
counter ``syncs``.
"""

from __future__ import annotations

PASSES = ("model.forward", "model.backward")


def records():
    """The program's finished spans, or None where it keeps no log."""
    try:
        from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


class Log:
    """Spans indexed by id, with each span's children."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.by_id = {s["id"]: s for s in self.spans}
        self.children: dict = {}
        for s in self.spans:
            self.children.setdefault(s["parent"], []).append(s)

    def outermost(self, name: str) -> list:
        """Spans named ``name`` with no span of that name above them."""
        return [s for s in self.spans if s["name"] == name
                and not any(a["name"] == name for a in self.ancestors(s))]

    def ancestors(self, span) -> list:
        out, parent = [], span["parent"]
        while parent in self.by_id:
            out.append(self.by_id[parent])
            parent = self.by_id[parent]["parent"]
        return out

    def subtree(self, span) -> list:
        """``span`` and every span below it."""
        out, todo = [], [span]
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(self.children.get(s["id"], []))
        return out

    def leaves(self, span) -> list:
        return [s for s in self.subtree(span) if s["id"] not in self.children]


def load(spans=None) -> Log | None:
    """The log of ``spans``, by default the program's; None where it is
    missing or empty."""
    spans = records() if spans is None else spans
    return Log(spans) if spans else None


def counted(spans, name: str = "syncs") -> tuple[int, float]:
    """(count, blocked host seconds) of counter ``name`` over ``spans``."""
    n, blocked = 0, 0.0
    for s in spans:
        c = s["counts"].get(name)
        if c:
            n += c["n"]
            blocked += c["blocked_s"]
    return n, blocked


def syncs_per_step(log: Log, root: str, step: str) -> float | None:
    """``syncs`` inside the ``root`` spans over the ``step`` spans in them."""
    inside = [s for r in log.outermost(root) for s in log.subtree(r)]
    steps = sum(1 for s in inside if s["name"] == step)
    return counted(inside)[0] / steps if steps else None


def issue_ms_per_pass(log: Log, root: str) -> float | None:
    """Host ms of the passes inside the ``root`` spans, less the host seconds
    their ``syncs`` blocked, over the passes (a pass is one outermost
    ``model.forward`` or ``model.backward``)."""
    passes = [s for r in log.outermost(root) for s in log.subtree(r)
              if s["name"] in PASSES and not any(a["name"] in PASSES
                                                 for a in log.ancestors(s))]
    if not passes:
        return None
    host_ns = sum(s["host_exit_ns"] - s["host_enter_ns"] for s in passes)
    blocked = counted([d for s in passes for d in log.subtree(s)])[1]
    return (host_ns / 1e9 - blocked) * 1e3 / len(passes)


def starved_share(log: Log, root: str) -> float | None:
    """Over the ``root`` spans' device extents: the share (%) that no leaf
    span's device interval covers, the gaps between consecutive leaves in
    stream order and before the first and after the last."""
    extent = gaps = 0
    for r in log.outermost(root):
        lo, hi = r["device_enter_ns"], r["device_exit_ns"]
        leaves = [s for s in log.leaves(r) if s is not r]
        if lo is None or not leaves or any(s["device_enter_ns"] is None for s in leaves):
            return None
        covered = lo
        for s in sorted(leaves, key=lambda s: s["device_enter_ns"]):
            gaps += max(0, s["device_enter_ns"] - covered)
            covered = max(covered, s["device_exit_ns"])
        gaps += max(0, hi - covered)
        extent += hi - lo
    return 100.0 * gaps / extent if extent else None


def device_ms_per_cell(log: Log, name: str) -> float | None:
    """Device ms of the spans named ``name`` directly under a
    ``defense.eval``, over the ``defense.eval`` spans (the batches)."""
    cells = log.outermost("defense.eval")
    hits = [s for c in cells for s in log.children.get(c["id"], []) if s["name"] == name]
    if not cells or not hits or any(s["device_enter_ns"] is None for s in hits):
        return None
    return sum(s["device_exit_ns"] - s["device_enter_ns"] for s in hits) / 1e6 / len(cells)
