"""The host's issue of a detect call's device work
(``algorithms/base.py:_batched_detections``: the letterbox, the forward, the
decode and the NMS): milliseconds a call on the host clock in the program's
span ``tpucv.detect.queue`` over the traced window (``_span.ms_per``). None
where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/call"


def read(ctx):
    return _span.ms_per(ctx, "detect", "tpucv.detect.queue")
