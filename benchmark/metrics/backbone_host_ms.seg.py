"""DeepLabV3+'s forward, the dilated ResNet-101 (``models/resnet.py``):
milliseconds a training step on the host clock in the program's span
``tpucv.seg.backbone`` over the traced window (``_span.ms_per``). None where
the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/step"


def read(ctx):
    return _span.ms_per(ctx, "train", "tpucv.seg.backbone")
