"""Device ms a forward pass of an eval cell's Swin blocks' attention halves:
the program's ``swin.attn`` spans (norm1, the shifted or plain window
attention, its residual add) by their device events, over the ``model.net``
spans that hold them (``model_spans.py``).  None where no model opens them."""

from benchmark_port import model_spans, spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return model_spans.device_ms_per_pass(log, "swin.attn")
