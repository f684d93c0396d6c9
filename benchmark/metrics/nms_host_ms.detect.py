"""The NMS of a detect call (``ops/nms.py:dispatch_batched_nms``, either
engine: ``nms_keep`` or the sequential scan; it lies inside
``tpucv.detect.queue``): milliseconds a call on the host clock in the
program's span ``tpucv.nms`` over the traced window (``_span.ms_per``). None
where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/call"


def read(ctx):
    return _span.ms_per(ctx, "detect", "tpucv.nms")
