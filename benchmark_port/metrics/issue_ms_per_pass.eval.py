"""The host's issue time per model pass in the attack loop of an eval cell:
host ms of the ``model.forward`` and ``model.backward`` spans inside the
program's ``attack`` spans, less the host seconds their ``syncs`` blocked,
over the passes (``spanlog.py``)."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return spanlog.issue_ms_per_pass(log, "attack")
