"""The collectives (``parallel/mesh.py``: global-batch BatchNorm's
all-reduces, the head outputs' and targets' all-gathers, the gradients'
all-reduce): milliseconds a step of kernels whose names begin with
``nccl`` on rank 0 (profiler). None on one card."""

UNIT = "ms"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    s = sum(t1 - t0 for n, t0, t1 in ctx["trace"].kernels()
            if n.lower().startswith("nccl")) * 1e-3
    return s / ctx["steps"] if s > 0 else None
