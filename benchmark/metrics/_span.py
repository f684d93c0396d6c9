"""What the readers of the program's spans (``tpucv_torch.utils.profile``)
share; not a metric itself (``BENCHMARK.json`` names none by this file)."""


def ms_per(ctx, kind: str, span: str):
    """Milliseconds of the program's span ``span`` a detect call (``kind``
    "detect") or a training step ("train") in the traced window: the sum of
    the span's records that opened while the window's profiler ran, over
    the window's ``batches`` or ``steps``. So a span that closes more than
    once a call or a step (the forward, loss and backward at ``grad_accum``
    2) counts each time, and what the program runs after the window, with
    no profiler, counts not at all. None in a cell of another kind, or
    where the program recorded no such span in the window; a program from
    before the recorder, which the traced runs of the parent meet, has no
    ``profiled``."""
    n = ctx.get("batches" if kind == "detect" else "steps")
    if ctx["kind"] != kind or not n:
        return None
    from tpucv_torch.utils import profile

    profiled = getattr(profile, "profiled", None)
    ns = profiled(span) if profiled is not None else []
    return sum(ns) / n * 1e-6 if ns else None
