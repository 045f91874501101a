"""The share of the device time of a eval cell's traced stretch spent in
normalization kernels (BatchNorm, LayerNorm) and in copies and layout
transforms, by the name classes of ``kernel_classes.json``."""

CLASSES = ("batchnorm", "layernorm", "copies and layout transforms")


def read(summary):
    if summary["kind"] != "eval" or not summary["kernel_total_s"]:
        return None
    part = sum(summary["by_class_s"].get(c, 0.0) for c in CLASSES)
    return 100.0 * part / summary["kernel_total_s"]
