"""The device in the training cells: the share of the traced window in
which no operation ran on it (profiler timeline), averaged over the
ranks."""

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
