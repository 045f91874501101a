"""The pgd_step update's share of its roofline: the least time its calls' bytes
need at the card's memory rate (``kernels/pgd_step.py``, ``peaks.json``) over
the device time of the kernels that implement it in the traced stretch.
Nothing to read where no such kernel ran."""


def read(summary):
    k = summary["kernels"].get("pgd_step")
    if not k or not k["device_s"]:
        return None
    return 100.0 * k["least_s"] / k["device_s"]
