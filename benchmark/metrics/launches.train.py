"""The eager step's host issue (``train/state.py``): CUDA kernel launches
(runtime calls named ``cudaLaunchKernel*``) a step on rank 0, profiler."""

UNIT = "launches"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    tr = ctx["trace"]
    n = sum(1 for name, _, _ in tr.in_window(tr.runtime)
            if "LaunchKernel" in name)
    return n / ctx["steps"] if n else None
