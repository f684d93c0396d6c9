"""The network's forward (``models/yolov8.py`` / ``models/yolov7.py`` on
``nn/blocks.py``): milliseconds a batch on the device, from CUDA events
that forward pre- and post-hooks on the model record."""

UNIT = "ms"


def read(ctx):
    ms = ctx.get("forward_ms") if ctx["kind"] == "detect" else None
    return sum(ms) / len(ms) if ms else None
