"""The quantize update's share of its roofline: the least time its calls' bytes
need at the card's memory rate (``kernels/quantize.py``, ``peaks.json``) over
the device time of the kernels that implement it in the traced stretch.
Nothing to read where no such kernel ran."""


def read(summary):
    k = summary["kernels"].get("quantize")
    if not k or not k["device_s"]:
        return None
    return 100.0 * k["least_s"] / k["device_s"]
