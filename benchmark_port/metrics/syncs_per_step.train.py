"""Waits on the device per training step: the program's ``syncs`` counts
inside its ``train.step`` spans over those spans, from the traced
stretch's span log (``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "train" or log is None:
        return None
    return spanlog.syncs_per_step(log, "train.step", "train.step")
