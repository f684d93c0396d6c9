"""A configuration, a cell and a per-layer metric added as new files are
found by name, with no file of the harness edited."""

from __future__ import annotations

import json
import shutil

from benchmark.tests.conftest import REPO, run_cell

READER = '''"""A test reader: the traced window's batches."""

UNIT = "batches"


def read(ctx):
    return ctx.get("batches") if ctx["kind"] == "detect" else None
'''


def test_added_files_are_found(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "yolov8l-coco640.json").read_text())
    cfg["name"] = "yolov8m-coco640"
    cfg["overrides"]["arch.model_type"] = "m"
    cfg["network"]["scale"] = "m"
    (b / "configs" / "yolov8m-coco640.json").write_text(json.dumps(cfg))
    cell = json.loads((b / "workloads" / "yolov8l-detect-b32.json").read_text())
    cell["config"] = "yolov8m-coco640"
    (b / "workloads" / "yolov8m-detect-b16.json").write_text(json.dumps(cell))
    (b / "metrics" / "calls.detect.py").write_text(READER)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "calls.detect", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "device", "moves": "detect_img_s",
        "workloads": ["yolov8m-detect-b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = {"PYTHONPATH": f"{tmp_path}:{REPO}"}
    rc, line, err = run_cell("yolov8m-detect-b16", "--device", "cpu",
                             "--small", cwd=tmp_path, env=env, trace=1)
    assert rc == 0, err[-3000:]
    assert line["metrics"]["calls.detect"]["value"] == 2
    assert line["correct"] is True
