"""The share of the attack loop's device time that waits on the host: over
the device extent of the program's ``attack`` spans, the part no leaf
span covers (the device gaps between consecutive leaf spans in stream
order), in % (``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return spanlog.starved_share(log, "attack")
