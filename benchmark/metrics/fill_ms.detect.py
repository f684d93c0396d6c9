"""Host canvas fill (``algorithms/base.py:_fill_canvases``): milliseconds a
batch on the host clock, from the benchmark's wrapper around the method,
over the traced window's calls (their total spans the window's share)."""

UNIT = "ms"


def read(ctx):
    if ctx["kind"] != "detect" or not ctx.get("fills"):
        return None
    return ctx["fill_s"] / ctx["fills"] * 1e3
