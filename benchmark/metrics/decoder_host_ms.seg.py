"""DeepLabV3+'s forward, the decoder (the low-level projection, the resize
to its size, the concat, the 3x3, the classifier and the resize to the
input): milliseconds a training step on the host clock in the program's
span ``tpucv.seg.decoder`` over the traced window (``_span.ms_per``).
None where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/step"


def read(ctx):
    return _span.ms_per(ctx, "train", "tpucv.seg.decoder")
