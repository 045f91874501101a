"""The share of a training step's device time that waits on the host: over
the device extent of the program's ``train.step`` spans, the part no leaf
span covers (the device gaps between consecutive leaf spans in stream
order), in % (``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "train" or log is None:
        return None
    return spanlog.starved_share(log, "train.step")
