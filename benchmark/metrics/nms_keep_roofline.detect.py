"""``csrc/nms.cu`` through ``ops/cuda_nms.py``: the share of the least time
in the time ``nms_build_kernel`` and ``nms_walk_kernel`` took in the
traced window (profiler). The least time of each call is counted by
``benchmark.nms_cost`` from that call's inputs, whatever implements the
NMS. None where no such kernel ran (the scan's cells)."""

from benchmark import nms_cost

UNIT = "%"
KERNELS = ("nms_build_kernel", "nms_walk_kernel")


def read(ctx):
    if ctx["kind"] != "detect":
        return None
    kernel_s = sum(t1 - t0 for n, t0, t1 in ctx["trace"].kernels()
                   if any(k in n for k in KERNELS)) * 1e-6
    calls = ctx.get("nms_inputs", [])
    if kernel_s <= 0 or not calls:
        return None
    least_s = sum(nms_cost.least_s(b, s, thr) for b, s, thr in calls)
    return 100.0 * least_s / kernel_s
