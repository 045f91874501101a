"""The share of an untraced eval window in which the device was idle: one
less the device's busy time per unit (the union of the device intervals in
the traced stretch, over its units) over the untraced window's seconds per
unit.  The traced stretch's own idle share (``device.busy_s`` over
``device.window_s``) is higher by the profiler's cost on the host, about
0.04-0.1 s a unit; busy time per unit is the same with the profiler on or
off, so it is divided by the untraced time."""


def read(summary):
    u = summary["untraced"]
    if summary["kind"] != "eval" or not summary["kernel_count"] or not u["units"]:
        return None
    return 100.0 * (1.0 - (summary["busy_s"] / summary["units"]) / (u["seconds"] / u["units"]))
