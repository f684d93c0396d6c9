"""Profiling helpers (counterpart of ``tpucv/utils/profile.py``): the
reference's ``Profile`` timing context, a ``torch.profiler`` trace, and the
port's one span recorder.

``span(name)`` times its block on the host clock and keeps, for each name,
its newest ``RING`` records (``recent``, ``profiled``, ``names``,
``reset``). While a ``torch.profiler`` session is running
(``trace`` below, or any other), the span is also a ``record_function``
of the same name, so it sits in the Chrome trace on the profiler's clock
beside the kernels, copies and runtime calls it issued. Inside
``torch.compile`` or ``torch.export`` a span does nothing, so a compiled
or exported graph gains no node from it.

The program's spans: ``tpucv.detect.{fill,upload,queue,download,unbox}``
tile each batch of ``DetectionAlgorithm._batched_detections`` and of
YOLOv8-pose's evaluation (int8 calibration records ``fill`` and
``upload``),
``tpucv.nms`` covers ``ops.nms.dispatch_batched_nms`` (either engine), and
``tpucv.train.{forward,loss,backward,optimizer}`` the stages of
``train.state.make_train_step``'s step, and
``tpucv.seg.{backbone,aspp,decoder}`` the stages of DeepLabV3+'s forward
(``models/deeplabv3plus.py``; inside ``tpucv.train.forward`` in a step).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Deque, Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 4096     # records kept a span name


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


class Spans:
    """Each span name's newest ``RING`` records: the duration (ns), and
    whether a profiler ran as the span opened. Thread-safe: the serving
    batcher records while the HTTP handlers read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rings: Dict[str, Deque[Tuple[int, bool]]] = {}

    def add(self, name: str, ns: int, profiled: bool = False) -> None:
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                ring = self._rings[name] = collections.deque(maxlen=RING)
            ring.append((ns, profiled))

    def _ring(self, name: str) -> List[Tuple[int, bool]]:
        with self._lock:
            return list(self._rings.get(name, ()))

    def recent(self, name: str, n: int) -> List[int]:
        """The newest ``n`` durations of ``name`` in ns, oldest first; fewer
        where fewer were kept."""
        ring = self._ring(name)
        return [ns for ns, _ in ring[max(len(ring) - n, 0):]] if n > 0 else []

    def profiled(self, name: str) -> List[int]:
        """The durations of ``name`` (ns, oldest first) in the newest run of
        its records that opened while a profiler ran, which is the newest
        traced window's, with the untraced records after it left out.
        Empty where there is no such run, or where it fills the ring (its
        oldest records may be gone)."""
        ring = self._ring(name)
        end = len(ring)
        while end and not ring[end - 1][1]:
            end -= 1
        start = end
        while start and ring[start - 1][1]:
            start -= 1
        if start == 0 and len(ring) == RING:
            return []
        return [ns for ns, _ in ring[start:end]]

    def names(self) -> List[str]:
        with self._lock:
            return list(self._rings)

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()


SPANS = Spans()
recent, profiled, names, reset = \
    SPANS.recent, SPANS.profiled, SPANS.names, SPANS.reset


class span:
    """``with span(name): ...`` records the block's host time in ``SPANS``
    and, while a profiler runs, marks it in the trace as a
    ``record_function``. A no-op while ``torch.compile`` or
    ``torch.export`` traces the block."""

    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if torch.compiler.is_compiling():
            self._t0 = None
            return self
        # the module's flag, read each time: a bare record_function costs
        # ~10x this span with no profiler running
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        SPANS.add(self.name, ns, self._rf is not None)
        return False
