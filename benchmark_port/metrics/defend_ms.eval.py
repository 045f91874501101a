"""Device ms of the preprocessing defense per batch of the defense cell: the
program's ``defense.defend`` spans directly under ``defense.eval`` (the
smoothing and the quantize kernel), by their device events
(``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return spanlog.device_ms_per_cell(log, "defense.defend")
