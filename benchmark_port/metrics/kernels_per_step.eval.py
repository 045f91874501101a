"""Device operations in the traced stretch of a eval cell per step (PGD steps
of the attack loop, or training steps): the launch count that a fused or
graphed step lowers."""


def read(summary):
    if summary["kind"] != "eval" or not summary["steps"] or not summary["kernel_count"]:
        return None
    return summary["kernel_count"] / summary["steps"]
