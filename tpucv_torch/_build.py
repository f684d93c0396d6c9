"""Build the port's native sources into shared libraries, on first use.

Two kinds of source, one build path:

- each ``csrc/<name>.cu`` (a device kernel) is compiled by ``nvcc`` for
  ``sm_90a``; flags are common to every source, plus a source's own
  (``SOURCE_FLAGS``). Sources include no PyTorch header, so a build takes
  seconds. ``build`` starts one ``nvcc`` per source, all at once.
- each ``native/<name>.cpp`` (host C++: the COCOeval matcher, the JPEG
  pipeline) is compiled by ``g++`` (``build_native``), with its own link
  flags (``NATIVE_LINK``). A failed g++ build is remembered on disk, so
  a host that lacks a library's headers runs g++ for it once.

Each library goes to ``_build/lib<name>-<digest>.so`` and is loaded with
``ctypes``; the digest covers the source and the flags, so an edited source
rebuilds and a stale library is never loaded. A compiler writes to a name
of its own process and ``os.replace`` moves the finished file into place,
so processes that build the same library at once never read half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
SOURCE_FLAGS = {
    # no FMA contraction: the NMS IoU must round as XLA and PyTorch do
    "nms": ["--fmad=false"],
    "nms_scan": ["--fmad=false"],
}
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
NATIVE_LINK = {
    "imagepipe": ["-ljpeg", "-lpthread"],
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


def _digest_path(src: Path, flags: List[str]) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def lib_path(name: str) -> Path:
    return _digest_path(CSRC / f"{name}.cu", nvcc_flags(name))


def native_path(name: str) -> Path:
    return _digest_path(NATIVE / f"{name}.cpp",
                        [*GXX_FLAGS, *NATIVE_LINK.get(name, [])])


def _compile(jobs: Dict[str, tuple]):
    """Run one compiler process a job, all at once. ``jobs`` maps a name
    to ``(out, command, inputs)``: ``command -o tmp inputs`` writes
    ``tmp``, a name of this process beside ``out``, which is moved into
    place when the compiler succeeds. Returns (name -> compiler output,
    [failure messages])."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (out, command, inputs) in jobs.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [*command, "-o", str(tmp), *inputs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    return logs, failed


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named CUDA source that has no current library, one
    nvcc process each, started together. Returns name -> the nvcc and
    ptxas output of its build ("" when the library was already current)."""
    names = list(names)
    jobs = {name: (lib_path(name), [_nvcc(), *nvcc_flags(name)],
                   [str(CSRC / f"{name}.cu")])
            for name in names if not lib_path(name).exists()}
    logs, failed = _compile(jobs)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {name: logs.get(name, "") for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if needed, loaded."""
    with _lock:
        build([name])
        return ctypes.CDLL(str(lib_path(name)))


def build_native(name: str) -> Path:
    """The library for ``native/<name>.cpp``, compiled by g++ if it has no
    current one. Raises RuntimeError when g++ is missing or fails. A failed
    build leaves ``lib<name>-<digest>.failed`` (the compiler's output)
    beside where the library would be, and later calls raise at once
    rather than run g++ again: a host without the library's headers stays
    without them. Delete the file to try again."""
    out = native_path(name)
    if out.exists():
        return out
    marker = out.with_suffix(".failed")
    if marker.exists():
        raise RuntimeError(f"native build failed before ({marker}):\n"
                           + marker.read_text())
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    _, failed = _compile({name: (
        out, [gxx, *GXX_FLAGS],
        [str(NATIVE / f"{name}.cpp"), *NATIVE_LINK.get(name, [])])})
    if failed:
        tmp = marker.with_name(f"{marker.name}.{os.getpid()}.tmp")
        tmp.write_text("\n".join(failed))
        os.replace(tmp, marker)
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return out
