"""The host's issue time per model pass of a training step: host ms of the
``model.forward`` and ``model.backward`` spans inside the program's
``train.step`` spans, less the host seconds their ``syncs`` blocked, over
the passes (``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "train" or log is None:
        return None
    return spanlog.issue_ms_per_pass(log, "train.step")
