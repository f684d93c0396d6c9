"""A whole step against the chips: the step's FLOPs an image (forward and
backward, the configuration file's ``FlopCounterMode`` count over the
reference) times the images of the traced window on all ranks, over its
seconds and ranks x the dense bf16 peak, 989 TFLOP/s."""

from benchmark.common import H100_BF16_FLOPS

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0 or not ctx["images"]:
        return None
    return (100.0 * ctx["flops_per_image"] * ctx["images"]
            / ctx["window_s"] / (ctx["ranks"] * H100_BF16_FLOPS))
