"""Shared helpers of the benchmark's CPU tests: each run is a fresh
process of ``python -m benchmark.run`` (or ``benchmark.control``) at the
cell's tiny shapes on the CPU, from the repository's root."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = ["yolov8l-detect-b32", "yolov7l-detect-b32", "yolov8l-train-b16",
         "yolov8l-train-ddp4"]


def run_cell(cell: str, *extra: str, cwd: Path = REPO, env=None,
             seed: int = 2147483711, trace: int = 0, timeout: int = 600):
    """(exit code, the last stdout line as JSON or None, stderr)."""
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", cell,
           "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
           *extra]
    e = dict(os.environ, **(env or {}))
    e.setdefault("OMP_NUM_THREADS", "4")
    out = subprocess.run(cmd, cwd=cwd, env=e, capture_output=True, text=True,
                         timeout=timeout)
    lines = out.stdout.strip().splitlines()
    return out.returncode, (json.loads(lines[-1]) if lines else None), \
        out.stderr


@pytest.fixture
def no_card():
    """Skip where CUDA is available: the test is of a machine without it."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
