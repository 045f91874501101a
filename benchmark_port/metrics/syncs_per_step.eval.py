"""Waits on the device per PGD step of an eval cell: the program's ``syncs``
counts inside its ``attack`` spans over the ``attack.step`` spans in them,
from the traced stretch's span log (``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return spanlog.syncs_per_step(log, "attack", "attack.step")
