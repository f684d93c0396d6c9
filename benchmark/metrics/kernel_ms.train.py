"""The device in the training cells: summed kernel time a step on rank 0,
milliseconds (profiler)."""

UNIT = "ms"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    s = sum(t1 - t0 for _, t0, t1 in ctx["trace"].kernels()) * 1e-3
    return s / ctx["steps"] if s > 0 else None
