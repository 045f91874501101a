"""The share (%) of the window attentions in an eval cell's traced stretch
that took the shifted-window attention kernels: the program's
``window_attn.fused`` counts over ``window_attn.fused`` +
``window_attn.written``, one a window attention, from the span log
(``spanlog.py``).  None where the program counts neither."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    fused = spanlog.counted(log.spans, "window_attn.fused")[0]
    written = spanlog.counted(log.spans, "window_attn.written")[0]
    return 100.0 * fused / (fused + written) if fused + written else None
