"""The fetches of a detect call's results
(``algorithms/base.py:_batched_detections``), in which the host waits for
the device: milliseconds a call on the host clock in the program's span
``tpucv.detect.download`` over the traced window (``_span.ms_per``). None
where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/call"


def read(ctx):
    return _span.ms_per(ctx, "detect", "tpucv.detect.download")
