"""The share (%) of the ResNet chains (BatchNorm -> add -> ReLU) in a training
cell's traced stretch that took the fused kernels: the program's
``bn_fused`` counts over ``bn_fused`` + ``bn_plain``, one a chain, from the
span log (``spanlog.py``).  None where the program counts neither."""

from benchmark_port import spanlog


def read(summary, spans=None):
    log = spanlog.load(spans)
    if summary["kind"] != "train" or log is None:
        return None
    fused = spanlog.counted(log.spans, "bn_fused")[0]
    plain = spanlog.counted(log.spans, "bn_plain")[0]
    return 100.0 * fused / (fused + plain) if fused + plain else None
