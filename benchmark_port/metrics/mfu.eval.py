"""The whole model step's share of the card's bf16 dense peak in the
untraced window of a eval cell: the model FLOPs of the window's finished
examples (``flops/<family>.py``: each forward 1x, each input-gradient
chain and each weight gradient 1x more, recomputation not counted) over the
window's seconds and the published peak (``peaks.json``)."""


def read(summary):
    if summary["kind"] != "eval" or not summary["untraced"]["seconds"]:
        return None
    u = summary["untraced"]
    return 100.0 * u["model_flops"] / u["seconds"] / summary["peaks"]["bf16_dense_flops"]
