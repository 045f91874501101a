"""Device ms a forward pass of an eval cell's Swin blocks' MLP halves: the
program's ``swin.mlp`` spans (norm2, the two linear layers and the GELU, the
residual add) by their device events, over the ``model.net`` spans that
hold them (``model_spans.py``).  None where no model opens them."""

from benchmark_port import model_spans, spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    return model_spans.device_ms_per_pass(log, "swin.mlp")
