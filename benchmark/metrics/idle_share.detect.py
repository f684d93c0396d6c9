"""The device in the detection cells: the share of the traced window in
which no operation ran on it (profiler timeline)."""

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "detect" or ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
