"""The NMS (``ops/nms.py:dispatch_batched_nms``: ``nms_keep`` at K <= 1,024,
the sequential scan above): milliseconds a call on the device, from CUDA
events around each call, which the benchmark's wrapper records."""

UNIT = "ms"


def read(ctx):
    ms = ctx.get("nms_ms") if ctx["kind"] == "detect" else None
    return sum(ms) / len(ms) if ms else None
