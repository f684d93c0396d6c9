"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the measured program either: each checked in
a fresh process, by top-level module names compared whole."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tpucv"}


def modules_of(package: str):
    root = REPO / package.replace(".", "/")
    out = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        if "tests" in rel.parts or "." in rel.name:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def loaded_after_import(mods):
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    mods = modules_of("benchmark")
    assert "benchmark.run" in mods and "benchmark.drivers.train_ddp" in mods
    top = loaded_after_import(mods + ["tpucv_torch.builder"])
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "tpucv_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = loaded_after_import(modules_of("benchmark.reference"))
    assert not top & (FORBIDDEN | {"tpucv_torch"})


def test_metric_readers_load_no_jax():
    code = ("import json, sys\nfrom benchmark import metrics\n"
            "for n in metrics.names_for('yolov8l-train-ddp4') + "
            "metrics.names_for('yolov8l-detect-b32'): metrics.reader(n)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"tpucv_torch"})
