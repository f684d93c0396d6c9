"""A detect call's boxes back to original pixels
(``algorithms/base.py:_batched_detections``: ``reverse_letter_box`` and the
valid masks of every image): milliseconds a call on the host clock in the
program's span ``tpucv.detect.unbox`` over the traced window
(``_span.ms_per``). None where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/call"


def read(ctx):
    return _span.ms_per(ctx, "detect", "tpucv.detect.unbox")
