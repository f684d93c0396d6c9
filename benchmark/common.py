"""What every cell shares: the files found by name, the device check, the
chip's peaks, the checks of a run and its result line.

Peaks (NVIDIA's H100 SXM data sheet, dense, without sparsity, at the full
700 W): 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / ".cache"

H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "tpucv")


def set_cache_dirs() -> None:
    """Every compiler cache the program might use, at fixed paths inside
    the checkout (``benchmark/.cache``), so that only a checkout's first
    run builds. The port's CUDA libraries build into ``tpucv_torch/_build``
    by a digest of their source."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def benchmark_spec() -> dict:
    """The root ``BENCHMARK.json``."""
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def seed_of(seed: int) -> int:
    """``--seed`` as a non-negative 63-bit seed."""
    return int(seed) % (2 ** 63)


def require_device(device: str, chips: int) -> None:
    """Refuse a measurement without the cards it asks for: no fallback to
    the CPU. ``device == "cpu"`` is the CPU tests' explicit request."""
    import torch

    if device == "cpu":
        return
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this benchmark measures the "
                         "H100 and prints no result without one")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards and "
                         f"{torch.cuda.device_count()} are visible")


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def device_info(dev, count: int, peak_bytes: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (``tpucv_torch`` is the program)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def mark(t0: float, label: str) -> None:
    """A set-up phase's end, as seconds since the process started, on
    standard error."""
    print(f"setup {label} {time.perf_counter() - t0:.3f}", file=sys.stderr,
          flush=True)


def checks_hold(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """Print the compared numbers beside their limits on standard error,
    last, and the result line on standard output, ``checks`` its last key.
    Refuse to print when the process holds a forbidden module."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def apply_overrides(obj, overrides: Dict[str, object]) -> None:
    """Set dotted attributes (``dataset.name``) of a program config."""
    for key, value in overrides.items():
        *path, last = key.split(".")
        target = obj
        for p in path:
            target = getattr(target, p)
        setattr(target, last, value)
