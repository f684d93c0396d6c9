"""Build the port's CUDA sources into plain-C shared libraries, on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<digest>.so`` and loaded with ``ctypes``; the digest
covers the source and the flags, so an edited source rebuilds and a stale
library is never loaded. Flags are common to every source, plus a
source's own (``SOURCE_FLAGS``). Sources include no PyTorch header, so a build
takes seconds. ``build`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
SOURCE_FLAGS = {
    # no FMA contraction: the NMS IoU must round as XLA and PyTorch do
    "nms": ["--fmad=false"],
}

_lock = threading.Lock()      # one build at a time in this process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_flags(name: str) -> list:
    """The flags ``csrc/<name>.cu`` is built with: the common ones and its
    own."""
    return [*NVCC_FLAGS, *SOURCE_FLAGS.get(name, [])]


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process each, started together. Returns name -> the nvcc and ptxas
    output of its build ("" when the library was already current)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    logs = {name: "" for name in names}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if needed, loaded."""
    with _lock:
        build([name])
        return ctypes.CDLL(str(lib_path(name)))
