"""The bilinear resizes of the training step (DeepLabV3+'s decoder: the
ASPP output to layer 1's size and the logits to the input's), forward
and backward: device milliseconds a step of the kernels whose names
contain ``upsample_bilinear2d``, on rank 0 (profiler). None where the
window ran no such kernel."""

UNIT = "ms"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    s = sum(t1 - t0 for name, t0, t1 in ctx["trace"].kernels()
            if "upsample_bilinear2d" in name) * 1e-3
    return s / ctx["steps"] if s > 0 else None
