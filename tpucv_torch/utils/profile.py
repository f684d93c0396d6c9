"""Profiling helpers (counterpart of ``tpucv/utils/profile.py``): the
reference's ``Profile`` timing context and a ``torch.profiler`` trace."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _last_tensor(x):
    """The last tensor of a (nested) tuple, list or dict, or None."""
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else \
        x if isinstance(x, (list, tuple)) else ()
    for v in reversed(list(items)):
        t = _last_tensor(v)
        if t is not None:
            return t
    return None


class Profile(contextlib.ContextDecorator):
    """Usable as ``with Profile() as p:`` or as ``@Profile()``: ``.dt`` is
    the last span's host seconds and ``.t`` accumulates them. The host
    clock does not wait for the card: call ``fence(x)`` on the span's
    output before it ends, and the span covers the card's work on it."""

    def __init__(self, t: float = 0.0):
        self.t = t
        self.dt = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.start
        self.t += self.dt
        return False

    @staticmethod
    def fence(x) -> None:
        """Wait until the card has finished the work queued on the device
        of ``x``'s last tensor (``x`` a tensor or a nested tuple, list or
        dict of them); nothing for a CPU tensor."""
        t = _last_tensor(x)
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("log", "torch-trace")):
    """Trace the block with ``torch.profiler`` (the host, and CUDA where
    there is a card) and write a Chrome trace, ``trace.json``, into
    ``log_dir``; yields ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
