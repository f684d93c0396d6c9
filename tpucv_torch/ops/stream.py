"""Streaming add-one through the hand-written CUDA kernel ``csrc/stream.cu``
-- the counterpart of ``scripts/probe_pallas_bw.py``'s Pallas
``ident_kernel`` (``out = in + 1``, one read and one write of every
element).

``add_one`` is the kernel's wrapper: on a CUDA tensor it launches the
kernel or raises; on a CPU tensor, and only there, it runs
``add_one_reference``, the plain PyTorch version (``x + 1``).
``stream_plan`` is its launch geometry, ``library_plan`` the same as the
built library reports it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

THREADS = 1024              # csrc/stream.cu kThreads: one 16-byte vector each


class StreamPlan(NamedTuple):
    """How ``add_one`` launches over n bf16 elements: T threads a CTA, one
    CTA a chunk of T 16-byte vectors, the vectors of the last CTA, the
    elements after the last whole vector (fewer than 8; the last CTA's),
    and the kernel's index width."""
    threads: int
    grid: int
    last_vectors: int
    tail_elements: int
    index_bits: int


def stream_plan(n: int) -> StreamPlan:
    n_vec = n // 8
    grid = max(1, -(-n_vec // THREADS))
    return StreamPlan(threads=THREADS, grid=grid,
                      last_vectors=n_vec - (grid - 1) * THREADS,
                      tail_elements=n % 8,
                      index_bits=32 if n_vec + THREADS <= 2 ** 32 - 1 else 64)


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` in bf16: the sum formed in f32 and rounded to nearest-even,
    as every bf16 add in PyTorch and XLA does."""
    return x + 1


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of csrc/stream.cu with its entry points typed."""
    lib.tpucv_add_one.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_void_p]
    lib.tpucv_add_one.restype = ctypes.c_int
    lib.tpucv_add_one_plan.argtypes = [ctypes.c_longlong,
                                       ctypes.POINTER(ctypes.c_longlong)]
    lib.tpucv_add_one_plan.restype = None
    lib.tpucv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpucv_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    from tpucv_torch import _build

    return typed(_build.load("stream"))


def library_plan(n: int) -> StreamPlan:
    """``stream_plan(n)`` as the built library computes it: the threads,
    CTAs and index width it launches with."""
    out = (ctypes.c_longlong * 3)()
    _lib().tpucv_add_one_plan(n, out)
    threads, grid, bits = out
    n_vec = n // 8
    return StreamPlan(threads=threads, grid=grid,
                      last_vectors=n_vec - (grid - 1) * threads,
                      tail_elements=n % 8, index_bits=bits)


def _check(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} wants bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} wants a contiguous tensor")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what} wants a 16-byte aligned tensor")


def launch(x: torch.Tensor, lib: Optional[ctypes.CDLL] = None
           ) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor, uncounted; ``lib``:
    another ``typed`` build of csrc/stream.cu (the ablation probe's)."""
    _check(x, "add_one")
    if x.device.type != "cuda":
        raise ValueError(f"the add_one kernel runs on cuda tensors, not "
                         f"{x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = lib or _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpucv_add_one(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"add_one kernel launch failed (n={x.numel()}): "
                           f"{lib.tpucv_cuda_error_string(err).decode()}")
    return y


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous bf16 tensor of any shape.

    CUDA tensors launch ``csrc/stream.cu`` on the current stream and count
    the launch in ``add_one.launches``; CPU tensors run
    ``add_one_reference``. Any other input raises."""
    _check(x, "add_one")
    if x.device.type == "cpu":
        return add_one_reference(x)
    y = launch(x)
    if x.numel():
        add_one.launches += 1
    return y


add_one.launches = 0
