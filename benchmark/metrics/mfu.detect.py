"""A whole batch against the chip: the forward's FLOPs an image (the
configuration file's ``FlopCounterMode`` count over the reference) times
the images of the traced window, over its seconds and the dense bf16
peak, 989 TFLOP/s (the card's power limit is printed beside it)."""

from benchmark.common import H100_BF16_FLOPS

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "detect" or ctx["window_s"] <= 0 or not ctx["images"]:
        return None
    return (100.0 * ctx["flops_per_image"] * ctx["images"]
            / ctx["window_s"] / H100_BF16_FLOPS)
