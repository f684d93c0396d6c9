"""The host-to-device copies of a detect call
(``algorithms/base.py:_batched_detections``: the canvases, from pageable
memory, and their geometry): milliseconds a call on the host clock in the
program's span ``tpucv.detect.upload`` over the traced window
(``_span.ms_per``). None where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/call"


def read(ctx):
    return _span.ms_per(ctx, "detect", "tpucv.detect.upload")
