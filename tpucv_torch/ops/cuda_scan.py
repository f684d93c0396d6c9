"""Greedy NMS by sequential scan through the hand-written CUDA kernel
``csrc/nms_scan.cu`` -- the counterpart of tpucv's XLA scan
(``tpucv/ops/nms.py:nms``, a vmapped ``lax.scan``); it replaces no Pallas
kernel.

``nms_scan`` is the kernel's wrapper. It calls the PyTorch operator
``tpucv::nms_scan`` (``torch.ops.tpucv.nms_scan``), so that
``torch.export`` and ``torch.compile`` keep the call as one node. On a
CUDA tensor the operator launches the kernel, one CTA an image for the
whole batch, or raises; on a CPU tensor, and only there, it runs
``nms_scan_reference``, the plain PyTorch version (a Python loop of
``max_det`` rounds). ``scan_plan`` is the launch geometry,
``library_plan`` the same as the built library reports it.

Two first-call costs are kept out of a process's set-up. The operator is
registered through ``torch.library.Library`` (a schema, CPU, CUDA and
fake implementations), not ``torch.library.custom_op``, whose first call
imports ``torch._dynamo`` (7.4 s on an H100 host). The library is built
on first use; on a host with a card and ``nvcc``, importing this module
starts that build in a thread and the first launch waits for it, so
nvcc's seconds overlap the rest of the set-up.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from tpucv_torch.ops.cuda_nms import NEG_INF, _check

MAX_SCAN_BOXES = 4096       # csrc/nms_scan.cu kMaxBoxes: configs' pre_nms_topk
MAX_THREADS = 1024          # kMaxThreads


class ScanPlan(NamedTuple):
    """How ``nms_scan`` launches for (B, K): threads a CTA, the candidates
    each thread owns (the least power of two that fits K in 1,024 threads),
    one CTA an image, and the dynamic shared memory (the CTA's boxes)."""
    threads: int
    per_thread: int
    ctas: int
    smem_bytes: int


def scan_plan(B: int, K: int) -> ScanPlan:
    c = 1
    while c * MAX_THREADS < K:
        c *= 2
    needed = -(-K // c)                 # threads that hold K, c a thread
    threads = -(-needed // 32) * 32
    return ScanPlan(threads=threads, per_thread=c, ctas=B,
                    smem_bytes=threads * c * 16)


def library_plan(B: int, K: int) -> ScanPlan:
    """``scan_plan(B, K)`` as the built library computes its launch."""
    out = (ctypes.c_longlong * 4)()
    _lib().tpucv_nms_scan_plan(B, K, out)
    return ScanPlan(*out)


def nms_scan_reference(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float, max_det: int,
                       diou: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sequential greedy: (B, N, 4), (B, N) -> (B, max_det) x2.
    Each step takes the best live candidate and kills what it overlaps —
    O(max_det * N) memory-light work, for candidate floods."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    live = torch.where(scores > 0, scores, torch.full_like(scores, NEG_INF))
    bi = torch.arange(boxes.shape[0], device=boxes.device)
    idxs, valids = [], []
    for _ in range(max_det):
        best = live.argmax(-1)                                 # (B,)
        at = lambda v: v[bi, best][:, None]                    # noqa: E731
        valids.append(at(live)[:, 0] > NEG_INF / 2)
        inter = ((torch.minimum(at(x2), x2) - torch.maximum(at(x1), x1))
                 .clamp(min=0) *
                 (torch.minimum(at(y2), y2) - torch.maximum(at(y1), y1))
                 .clamp(min=0))
        iou = inter / (at(areas) + areas - inter + 1e-7)
        if diou:
            cw = torch.maximum(at(x2), x2) - torch.minimum(at(x1), x1)
            ch = torch.maximum(at(y2), y2) - torch.minimum(at(y1), y1)
            rho2 = (at(cx) - cx) ** 2 + (at(cy) - cy) ** 2
            iou = iou - rho2 / (cw ** 2 + ch ** 2 + 1e-7)
        live = torch.where(iou > iou_threshold,
                           torch.full_like(live, NEG_INF), live)
        live[bi, best] = NEG_INF
        idxs.append(best.to(torch.int32))
    return torch.stack(idxs, 1), torch.stack(valids, 1)


def _prebuild() -> Optional[threading.Thread]:
    """Start compiling ``csrc/nms_scan.cu`` in a thread when the library is
    not current and the host has ``nvcc`` and a card; None otherwise."""
    from tpucv_torch import _build

    if _build.lib_path("nms_scan").exists():
        return None
    try:
        _build._nvcc()
    except RuntimeError:
        return None
    if not torch.cuda.is_available():
        return None

    def build():
        try:
            _build.build(["nms_scan"])
        except RuntimeError as err:      # raised again at the first launch
            thread.error = err

    thread = threading.Thread(target=build, name="tpucv-build-nms_scan",
                              daemon=True)
    thread.error = None
    thread.start()
    return thread


_PREBUILD = _prebuild()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use (or by the thread that
    importing this module started)."""
    from tpucv_torch import _build

    if _PREBUILD is not None:
        _PREBUILD.join()
        if _PREBUILD.error is not None:
            raise _PREBUILD.error
    return typed(_build.load("nms_scan"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of csrc/nms_scan.cu with its entry points typed."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpucv_nms_scan.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, f32,
                                   i32, ptr]
    lib.tpucv_nms_scan.restype = ctypes.c_int
    lib.tpucv_nms_scan_plan.argtypes = [i32, i32,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.tpucv_nms_scan_plan.restype = None
    lib.tpucv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpucv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _nms_scan_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float, max_det: int,
                   diou: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: the kernel's launch, counted in
    ``nms_scan.launches`` here, where the launch happens, so an exported or
    compiled program counts its launches too."""
    dev = boxes.device
    B, K = scores.shape
    if not 1 <= K <= MAX_SCAN_BOXES:
        raise ValueError(f"nms_scan kernel takes 1 <= K <= {MAX_SCAN_BOXES}, "
                         f"got {K}")
    idx = torch.empty((B, max_det), dtype=torch.int32, device=dev)
    valid = torch.empty((B, max_det), dtype=torch.bool, device=dev)
    if B == 0 or max_det == 0:
        return idx, valid
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tpucv_nms_scan(
            boxes.data_ptr(), scores.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), B, K, max_det, float(iou_threshold), int(diou),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_scan (B={B}, K={K}) kernel launch failed: "
                           f"{lib.tpucv_cuda_error_string(err).decode()}")
    nms_scan.launches += 1
    return idx, valid


_OPS = torch.library.Library("tpucv", "FRAGMENT")
_OPS.define("nms_scan(Tensor boxes, Tensor scores, float iou_threshold, "
            "int max_det, bool diou) -> (Tensor, Tensor)")
_OPS.impl("nms_scan", nms_scan_reference, "CPU")
_OPS.impl("nms_scan", _nms_scan_cuda, "CUDA")


@torch.library.register_fake("tpucv::nms_scan", lib=_OPS)
def _nms_scan_fake(boxes, scores, iou_threshold, max_det, diou):
    B = scores.shape[0]
    return (scores.new_empty((B, max_det), dtype=torch.int32),
            scores.new_empty((B, max_det), dtype=torch.bool))


def nms_scan(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float, max_det: int,
             diou: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS by sequential scan over (B, K, 4) xyxy boxes and (B, K)
    scores (<= 0 invalid; any order) -> (idx (B, max_det) int32 into the K
    axis, valid (B, max_det) bool), through the ``tpucv::nms_scan``
    operator. With ``diou`` the criterion is distance-IoU (CenterNet's).

    CUDA tensors launch ``csrc/nms_scan.cu`` (1 <= K <= 4,096) on the
    current stream, one launch a call counted in ``nms_scan.launches``;
    CPU tensors run ``nms_scan_reference``. Any other input raises."""
    _check(boxes, scores, "nms_scan")
    return torch.ops.tpucv.nms_scan(boxes, scores, float(iou_threshold),
                                    int(max_det), bool(diou))


nms_scan.launches = 0
