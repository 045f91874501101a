"""Device ms of the detector per batch of the defense cell: the program's two
``detector.score`` spans directly under ``defense.eval`` (the adversarial
and the clean batch's stage-3 features and score), by their device events
(``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return spanlog.device_ms_per_cell(log, "detector.score")
