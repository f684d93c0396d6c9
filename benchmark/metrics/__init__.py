"""Per-layer metrics: one reader a metric, ``benchmark/metrics/<metric>.py``
(the metric's name, dots and all), each with ``UNIT`` and ``read(ctx)``,
which returns the number, or None where the traced run holds nothing for
it to read (the harness then leaves the metric out of the line).

``ctx`` (a cell's traced window): ``kind`` ("detect" or "train"),
``trace`` (``benchmark.trace.Trace``), ``window_s``, ``busy_s`` (averaged
over the ranks), ``images``, ``ranks``, ``flops_per_image`` (the
configuration file's count for the work of an image), and the window
loop's probes: ``fill_s`` / ``fills``, ``forward_ms``, ``nms_ms``,
``nms_inputs`` (detection), ``steps`` (training).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict

from benchmark import common

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The reader module of metric ``name``."""
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names_for(cell: str):
    """The per-layer metrics ``BENCHMARK.json`` lists for ``cell``."""
    return [m["name"] for m in common.benchmark_spec()["per_layer"]
            if cell in m.get("workloads", [cell])]


def read_all(ctx: dict, cell: str) -> Dict[str, dict]:
    out = {}
    for name in names_for(cell):
        mod = reader(name)
        value = mod.read(ctx)
        if value is not None:
            out[name] = common.metric(value, mod.UNIT)
    return out
