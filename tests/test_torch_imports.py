"""The port imports nothing of JAX and nothing of tpucv.

Every module under ``tpucv_torch/`` and ``chip_smoke.py`` is parsed with
``ast`` (nothing is imported), and each ``import`` / ``from ... import``
statement, at any depth, is checked: ``jax`` and its submodules,
``jaxlib``, ``flax``, ``optax`` and ``tpucv`` with its submodules are
refused; ``tpucv_torch`` is the port's own. A relative import could not
leave the package, so only absolute ones are read.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpucv"}
SOURCES = sorted((ROOT / "tpucv_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def forbidden_imports(source: str):
    """(line, module) of each import of a forbidden package."""
    hits = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        hits += [(node.lineno, n) for n in names
                 if n.split(".")[0] in FORBIDDEN]
    return hits


def test_sources_found():
    assert len(SOURCES) > 80
    assert ROOT / "tpucv_torch" / "trainer" / "base.py" in SOURCES
    for name in ("ops/masks.py", "decode/yolov8_seg.py",
                 "decode/yolov8_pose.py", "losses/yolov8_seg.py",
                 "losses/yolov8_pose.py", "data/pose_dataset.py",
                 "algorithms/yolov8_seg.py", "trainer/yolo8_pose_train.py"):
        assert ROOT / "tpucv_torch" / name in SOURCES, name


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_no_jax_and_no_tpucv(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("from jax.experimental import pallas", True),
    ("import tpucv", True), ("from tpucv.data.loader import Loader", True),
    ("import tpucv.ops.augment as a", True), ("from tpucv import builder", True),
    ("def f():\n    import flax", True), ("import os, optax", True),
    ("import tpucv_torch", False), ("from tpucv_torch.data import loader", False),
    ("import jaxtyping", False), ("from . import x", False),
    ("x = 'import jax'", False),
])
def test_guard_catches_what_it_should(line, bad):
    assert bool(forbidden_imports(line)) is bad
