"""What the probes share: the device, timing on it, bounds and the checks.

Times on a CUDA device come from CUDA events around ``n`` back-to-back
calls after one warm-up call; on the CPU (the tests' tiny runs) from the
host clock, and they are labelled ``cpu``: they say nothing of the card.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_BF16_FLOPS = 989e12           # dense bf16 tensor cores, same sheet
BF16_ULP_REL = 2.0 ** -7           # one bf16 ulp at the largest value


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--small", action="store_true",
                   help="tiny shapes, for a run on the CPU")
    return p


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("this probe runs on CUDA, which is not available; "
                         "pass --device cpu --small for the plain versions")
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or cpu."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn: Callable[[], object], n: int, dev: torch.device) -> float:
    """Milliseconds a call, over ``n`` calls after one warm-up call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def timed_queued(fn: Callable[[], object], n: int,
                 dev: torch.device) -> float:
    """``timed`` for launches shorter than the host's cost of making them:
    the device first sleeps ~10 ms, so the host has queued all ``n`` calls
    before the first runs and the events time the device alone."""
    if dev.type != "cuda":
        return timed(fn, n, dev)
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def ablated_source(source: str, edits: Sequence[Tuple[str, str]]) -> str:
    """csrc/<source>.cu with each (text, replacement) of ``edits``
    applied; a text that is not in the source raises."""
    from tpucv_torch import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{old!r} is not in csrc/{source}.cu")
        src = src.replace(old, new)
    return src


def build_ablations(source: str, ablations: Dict[str, Sequence[Tuple[str, str]]],
                    out_dir: Path) -> Dict[str, Path]:
    """Each ablation of csrc/<source>.cu (name -> its edits) built with the
    source's own flags into ``out_dir``, one nvcc each, all at once; name
    -> the library's path."""
    from tpucv_torch import _build

    def one(name):
        src = out_dir / f"{source}_{name}.cu"
        src.write_text(ablated_source(source, ablations[name]))
        lib = out_dir / f"lib{source}_{name}.so"
        done = subprocess.run([_build._nvcc(), *_build.nvcc_flags(source),
                               "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"ablation {name} does not build:\n"
                               f"{done.stdout}{done.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(ablations)) as pool:
        return dict(pool.map(one, ablations))


def fence_fit(fn: Callable[[], object], dev: torch.device,
              ns: Sequence[int] = (20, 100, 400)
              ) -> Tuple[float, float, List[Tuple[int, float]]]:
    """Fit measured(n) = real + K/n over ``ns``, as
    scripts/probe_pallas_bw.py does; returns (real_ms, K_ms, points). With
    CUDA events K comes out near 0: nothing is paid once a batch."""
    pts = [(n, timed(fn, n, dev)) for n in ns]
    A = np.array([[1.0, 1.0 / n] for n, _ in pts])
    y = np.array([ms for _, ms in pts])
    real, k = np.linalg.lstsq(A, y, rcond=None)[0]
    return float(real), float(k), pts


def stream_bound_ms(nbytes: float) -> float:
    return nbytes / H100_HBM_BYTES_PER_S * 1e3


def conv_cost(B: int, S: int, C: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one 3x3 conv: x read once, y written once, the
    weight read once; 2*9*C*C FLOPs a pixel."""
    return 4 * B * S * S * C + 2 * 9 * C * C, 2 * B * S * S * 9 * C * C


def conv_bound(B: int, S: int, C: int) -> Tuple[float, str]:
    """Least time on an H100 for the conv, and what bounds it."""
    nbytes, flops = conv_cost(B, S, C)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def conv_inputs(B: int, S: int, C: int, dev: torch.device, seed: int = 0):
    """x ~ N(0, 1) and w ~ 0.1 N(0, 1), bf16, as the JAX probes draw them
    (from torch.Generator, so not the same numbers)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, S, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, C), generator=g, device=dev) * 0.1) \
        .to(torch.bfloat16)
    return x, w


def compare(got: torch.Tensor, ref: torch.Tensor) -> Tuple[int, float, float]:
    """(mismatches, max |got - ref|, max |ref|): elements further from ref
    than one bf16 ulp at the largest value, 2^-7 * max |ref|."""
    diff = (got.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    return int((diff > BF16_ULP_REL * scale).sum()), float(diff.max()), scale


def library_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """F.conv2d on the same NHWC bf16 data, seen as channels_last NCHW: the
    library call for the same function (a yardstick; the port never calls
    it)."""
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)
    return y.permute(0, 2, 3, 1)


def tile_rows_of(bhp: int, C: int, S: int) -> int:
    """A TPU block of ``bhp`` packed rows (128/C pixels each) as whole
    image rows of width S: the CTA's row tile."""
    return max(1, bhp * (128 // C) // S)


def rate_line(name: str, ms: float, dev: torch.device, flops: float,
              nbytes: float, bound_ms: float) -> str:
    line = f"{name:34s} {ms:9.4f} ms"
    if dev.type != "cuda":
        return line + "  (cpu)"
    return line + (f"  {flops / (ms * 1e-3) / 1e12:7.1f} TF/s"
                   f"  {nbytes / (ms * 1e-3) / 1e9:7.0f} GB/s"
                   f"  {bound_ms / ms:6.1%} of bound")


def run_conv_cases(cases, B: int, S: int, C: int, dev: torch.device,
                   n: int = 20) -> List[dict]:
    """The decomposition probes' loop: each case (name, tile_rows, mode,
    variant) on one shape, held against its own plain definition (and the full
    conv, to show what a timing-only variant leaves out), then timed."""
    from tpucv_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    x, w = conv_inputs(B, S, C, dev)
    full = conv3x3_reference(x, w)
    nbytes, flops = conv_cost(B, S, C)
    bound_ms, _ = conv_bound(B, S, C)
    rows = []
    for name, tile, mode, variant in cases:
        got = conv3x3(x, w, mode=mode, variant=variant, tile_rows=tile)
        plain = conv3x3_reference(x, w, variant, tile)
        bad, err, _ = compare(got, plain)
        if bad:
            raise RuntimeError(f"{name}: {bad} elements off the plain "
                               f"{variant} definition (max err {err})")
        _, err_full, scale_full = compare(got, full)
        ms = timed(lambda: conv3x3(x, w, mode=mode, variant=variant,
                                   tile_rows=tile), n, dev)
        print(rate_line(name, ms, dev, flops, nbytes, bound_ms) +
              f"  relerr vs full {err_full / scale_full:.1e}", flush=True)
        rows.append({"name": name, "mode": mode, "variant": variant,
                     "tile_rows": tile, "ms": ms, "max_abs_err": err,
                     "mismatches": bad,
                     "relerr_vs_full": err_full / scale_full})
    return rows
