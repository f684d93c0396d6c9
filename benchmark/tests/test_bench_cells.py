"""Every cell runs at tiny shapes on the CPU and prints a well-formed
line; without a card the measurement path refuses to run."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.conftest import CELLS, REPO, run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def e2e_names(cell):
    """The end-to-end metrics ``BENCHMARK.json`` gives ``cell``; for a
    cell it does not list (the four-card one), its driver's."""
    listed = {w["name"] for w in SPEC["workloads"]}
    if cell in listed:
        return {m["name"] for m in SPEC["end_to_end"]
                if cell in m.get("workloads", [cell])}
    return {"setup_s", "detect_img_s" if "detect" in cell else "train_img_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_line(cell):
    rc, line, err = run_cell(cell, "--device", "cpu", "--small")
    assert rc == 0, err[-3000:]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == e2e_names(cell)
    assert all(m["value"] > 0 for m in line["metrics"].values())
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["kind"] == "cpu"
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
        assert f"check {name} " in err


@pytest.mark.parametrize("cell", ["yolov8l-detect-b32", "yolov8l-train-b16"])
def test_traced_line(cell):
    rc, line, err = run_cell(cell, "--device", "cpu", "--small", trace=1)
    assert rc == 0, err[-3000:]
    listed = {m["name"] for m in SPEC["per_layer"]
              if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= listed
    assert ("mfu.detect" if "detect" in cell else "mfu.train") \
        in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_no_card_no_result(no_card):
    rc, line, err = run_cell("yolov8l-detect-b32")
    assert rc != 0 and line is None
    assert "CUDA is not available" in err


def test_only_benchmark_files_is_refused(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone (no program)
    exits non-zero and prints nothing."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    rc, line, _ = run_cell("yolov8l-detect-b32", "--device", "cpu", "--small",
                           cwd=tmp_path, env={"PYTHONPATH": str(tmp_path)})
    assert rc != 0 and line is None
