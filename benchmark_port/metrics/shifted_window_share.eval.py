"""The share (%) of the window attentions in an eval cell's traced stretch
that shifted the map: the program's ``window_attn.shifted`` counts over
``window_attn.shifted`` + ``window_attn.plain``, one a window attention,
from the span log (``spanlog.py``).  Swin-L at 224² shifts 11 of its 24
(45.83%).  None where the program counts neither."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "eval" or log is None:
        return None
    shifted = spanlog.counted(log.spans, "window_attn.shifted")[0]
    plain = spanlog.counted(log.spans, "window_attn.plain")[0]
    return 100.0 * shifted / (shifted + plain) if shifted + plain else None
