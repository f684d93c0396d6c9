"""DeepLabV3+'s forward, ASPP (``models/deeplabv3plus.py:ASPP``):
milliseconds a training step on the host clock in the program's span
``tpucv.seg.aspp`` over the traced window (``_span.ms_per``). None where
the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/step"


def read(ctx):
    return _span.ms_per(ctx, "train", "tpucv.seg.aspp")
