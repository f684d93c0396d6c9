"""The traced window: ``torch.profiler`` over CPU and CUDA activity, its
Chrome trace written under ``TMPDIR`` and read back, then deleted.

What the per-layer readers get (``Trace``): the device's operations
(kernels, copies, fills) with their times, the host's CUDA runtime calls
(kernel launches, copies, synchronisations) and the benchmark's own spans
(``record_function`` names that start with ``bench.``), all on the
profiler's one clock in microseconds, and the window as the span
``bench.window`` bounds it.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    runtime: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def in_window(self, ops):
        w0, w1 = self.window
        return [(n, max(t0, w0), min(t1, w1)) for n, t0, t1 in ops
                if t1 > w0 and t0 < w1]

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Kernels (no copies or fills) inside the window."""
        return [op for op in self.in_window(self.device_ops)
                if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations inside the window."""
        merged: List[List[float]] = []
        for _, t0, t1 in sorted(self.in_window(self.device_ops),
                                key=lambda o: o[1]):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        out, at = [], w0
        for a, b in self.busy_intervals():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if w1 > at:
            out.append((at, w1))
        return out

    def label(self, t: float) -> str:
        """What the host was doing at time ``t``: the innermost benchmark
        span, and a CUDA runtime call (a copy or a wait) if one covers it."""
        covering = [(t1 - t0, n) for n, t0, t1 in self.spans
                    if t0 <= t <= t1 and n != WINDOW]
        name = min(covering)[1] if covering else "outside spans"
        calls = [n for n, t0, t1 in self.runtime if t0 <= t <= t1]
        return name + (":" + calls[0] if calls else "")

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for n, t0, t1 in self.in_window(self.device_ops):
            by_name[n] = by_name.get(n, 0.0) + (t1 - t0) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self.label((a + b) / 2), (b - a) * 1e-6]
                              for a, b in gaps]}


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            tr.device_ops.append((name, t0, t1))
        elif cat == "cuda_runtime":
            tr.runtime.append((name, t0, t1))
        elif cat == "user_annotation" and name.startswith("bench."):
            tr.spans.append((name, t0, t1))
    windows = [(t0, t1) for n, t0, t1 in tr.spans if n == WINDOW]
    if windows:
        tr.window = windows[0]
    return tr


class Profiled:
    """``with Profiled(dev) as p: ... with p.window(): <the work>``; then
    ``p.trace`` holds the parsed trace."""

    def __init__(self, dev: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.dev = dev
        self.prof = profile(activities=acts)
        self.trace: Optional[Trace] = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def window(self):
        return torch.profiler.record_function(WINDOW)

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = read_chrome_trace(path)
        finally:
            os.unlink(path)
        return False
