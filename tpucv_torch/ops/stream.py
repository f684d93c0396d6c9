"""Streaming add-one through the hand-written CUDA kernel ``csrc/stream.cu``
-- the counterpart of ``scripts/probe_pallas_bw.py``'s Pallas
``ident_kernel`` (``out = in + 1``, one read and one write of every
element).

``add_one`` is the kernel's wrapper: on a CUDA tensor it launches the
kernel or raises; on a CPU tensor, and only there, it runs
``add_one_reference``, the plain PyTorch version (``x + 1``).
"""

from __future__ import annotations

import ctypes
import functools

import torch


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` in bf16: the sum formed in f32 and rounded to nearest-even,
    as every bf16 add in PyTorch and XLA does."""
    return x + 1


@functools.cache
def _lib() -> ctypes.CDLL:
    from tpucv_torch import _build

    lib = _build.load("stream")
    lib.tpucv_add_one.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_void_p]
    lib.tpucv_add_one.restype = ctypes.c_int
    lib.tpucv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpucv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous bf16 tensor of any shape.

    CUDA tensors launch ``csrc/stream.cu`` on the current stream and count
    the launch in ``add_one.launches``; CPU tensors run
    ``add_one_reference``. Any other input raises."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"add_one wants bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("add_one wants a contiguous tensor")
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one runs on cuda or cpu tensors, not {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("add_one wants a 16-byte aligned tensor")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpucv_add_one(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"add_one kernel launch failed (n={x.numel()}): "
                           f"{lib.tpucv_cuda_error_string(err).decode()}")
    add_one.launches += 1
    return y


add_one.launches = 0
