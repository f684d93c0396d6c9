"""The per-layer metrics read from the program's own spans
(``tpucv_torch.utils.profile``): a traced run of each cell prints every one
its cell lists, each above 0, and a detect call's stages fit in the
window's time a call. Each reader sums its span's records from the traced
window over the window's calls or steps, and against a program without
the span recorder gives None, so the line leaves the metric out."""

from __future__ import annotations

import json
import re
import sys
import types

import pytest

from benchmark import metrics
from benchmark.tests.conftest import REPO, run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in SPEC["per_layer"]
                if m["name"].endswith(("_host_ms.detect", "_host_ms.train"))}
STAGES = ["upload_host_ms.detect", "queue_host_ms.detect",
          "download_host_ms.detect", "unbox_host_ms.detect"]


def test_nine_span_metrics_are_listed():
    assert len(SPAN_METRICS) == 9
    assert all(m["source"] == "program_span" for m in SPAN_METRICS.values())


@pytest.mark.parametrize("cell", ["yolov8l-detect-b32", "yolov7l-detect-b32",
                                  "yolov8l-train-b16"])
def test_traced_line_reads_the_spans(cell):
    rc, line, err = run_cell(cell, "--device", "cpu", "--small", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    want = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]}
    assert len(want) == (5 if "detect" in cell else 4)
    got = line["metrics"]
    assert want <= set(got)
    assert all(got[n]["value"] > 0 for n in want)
    if "detect" in cell:
        calls = int(re.search(r"counter batches (\d+)", err).group(1))
        per_call_ms = line["device"]["window_s"] * 1e3 / calls
        staged = sum(got[n]["value"] for n in STAGES)
        assert staged + got["fill_ms.detect"]["value"] <= per_call_ms
        assert got["nms_host_ms.detect"]["value"] <= \
            got["queue_host_ms.detect"]["value"]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_without_the_recorder_gives_none(name, monkeypatch):
    """The span's traced records over the window's calls or steps: a span
    that closes twice a step counts both; None for a program whose
    ``utils.profile`` has no ``profiled``, or where it holds no record."""
    kind = "detect" if name.endswith(".detect") else "train"
    ctx = {"kind": kind, "batches": 2, "steps": 2}
    bare = types.ModuleType("tpucv_torch.utils.profile")
    monkeypatch.setitem(sys.modules, "tpucv_torch.utils.profile", bare)
    import tpucv_torch.utils
    monkeypatch.setattr(tpucv_torch.utils, "profile", bare, raising=False)
    mod = metrics.reader(name)
    assert mod.read(ctx) is None
    bare.profiled = lambda span: []
    assert mod.read(ctx) is None
    bare.profiled = lambda span: [1_000_000, 3_000_000]
    assert mod.read(ctx) == pytest.approx(2.0)
    bare.profiled = lambda span: [1_000_000, 3_000_000] * 2
    assert mod.read(ctx) == pytest.approx(4.0)
    other = {"kind": "train" if kind == "detect" else "detect",
             "batches": 2, "steps": 2}
    assert mod.read(other) is None
