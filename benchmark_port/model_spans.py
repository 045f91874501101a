"""Readings of the spans that a model opens inside its forward pass, from the
program's span log (``spanlog.py``): a pass is one ``model.net`` span, and
the model's layer spans lie below it (``models/swin.py``: ``swin.embed``,
``swin.attn``, ``swin.mlp``, ``swin.merge``, ``swin.head``).  A program or
model without such spans gives None."""

from __future__ import annotations


def device_ms_per_pass(log, name: str) -> float | None:
    """Device ms of the spans named ``name`` over the passes that hold one."""
    per_pass = [[s for s in log.subtree(net) if s["name"] == name]
                for net in log.spans if net["name"] == "model.net"]
    per_pass = [hits for hits in per_pass if hits]
    hits = [s for p in per_pass for s in p]
    if not hits or any(s["device_enter_ns"] is None for s in hits):
        return None
    return sum(s["device_exit_ns"] - s["device_enter_ns"] for s in hits) / 1e6 / len(per_pass)
