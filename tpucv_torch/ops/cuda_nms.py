"""Greedy NMS through the hand-written CUDA kernel ``csrc/nms.cu`` — the
counterpart of ``tpucv/ops/pallas_nms.py`` (``pallas_nms_keep`` and
``pallas_nms``, which launch the Pallas ``_nms_kernel``).

``nms_keep`` is the kernels' wrapper: on a CUDA tensor it launches the
mask build and the walk or raises; on a CPU tensor, and only there, it runs
``nms_keep_reference``, the plain PyTorch version of the same function
(the vectorised suppression-wave fixpoint of ``nms_fixpoint``).
``cuda_nms`` is the ``pallas_nms``-shaped wrapper around it: sort (unless
presorted), keep mask, top-``max_det`` selection.

For checking the two kernels apart: ``overlap_words`` runs the build alone
(plain twin ``overlap_words_reference``, the packed overlap matrix of
``nms_keep_reference``), ``walk_words`` the walk alone (plain twin
``walk_words_reference``, the same block-wise walk in PyTorch). The main
path calls neither. ``nms_plan`` is the launch geometry, ``library_plan``
the same as the built library reports it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e10
MAX_BOXES = 1024            # the kernels' shared-memory arrays hold K <= 1024
BUILD_THREADS = 256         # csrc/nms.cu kBuildThreads
WALK_THREADS = 128          # kWalkThreads: one walking warp, three loading
RING_BLOCKS = 4             # kRingBlocks: 32-row blocks of the mask in flight


class NmsPlan(NamedTuple):
    """How ``nms_keep`` launches for (B, K): the mask's words a row, its
    rows an image (K padded to whole 32-row blocks) and their stride in
    words (the words rounded up to whole 16-byte chunks), the build's grid
    (images, row sets), the walk's CTAs and the scratch it allocates."""
    words: int
    rows: int
    row_words: int
    build_grid: Tuple[int, int]
    walk_ctas: int
    scratch_bytes: int


def nms_plan(B: int, K: int) -> NmsPlan:
    W = -(-K // 32)
    Wp = -(-W // 4) * 4
    return NmsPlan(words=W, rows=32 * W, row_words=Wp, build_grid=(B, W),
                   walk_ctas=B, scratch_bytes=B * 32 * W * Wp * 4)


def library_plan(B: int, K: int) -> NmsPlan:
    """``nms_plan(B, K)`` as the built library computes the launches it
    makes."""
    out = (ctypes.c_longlong * 7)()
    _lib().tpucv_nms_plan(B, K, out)
    W, rows, Wp, bx, by, walk, scratch = out
    return NmsPlan(words=W, rows=rows, row_words=Wp, build_grid=(bx, by),
                   walk_ctas=walk, scratch_bytes=scratch)


def _scratch(p: NmsPlan, B: int, dev: torch.device, zero: bool = False):
    make = torch.zeros if zero else torch.empty
    return make((B, p.rows, p.row_words), dtype=torch.int32, device=dev)


def overlap_matrix(boxes_sorted: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """(B, K, K) bool: ``[b, i, j]`` when higher-ranked j (j < i) overlaps
    i with IoU above the threshold, in the kernel's f32 association."""
    K = boxes_sorted.shape[1]
    x1, y1, x2, y2 = boxes_sorted.unbind(-1)                 # (B, K)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix = (torch.minimum(x2[:, :, None], x2[:, None]) -
          torch.maximum(x1[:, :, None], x1[:, None])).clamp(min=0)
    iy = (torch.minimum(y2[:, :, None], y2[:, None]) -
          torch.maximum(y1[:, :, None], y1[:, None])).clamp(min=0)
    inter = ix * iy
    iou = inter / (area[:, :, None] + area[:, None] - inter + 1e-7)
    lower = torch.ones(K, K, dtype=torch.bool,
                       device=boxes_sorted.device).tril(-1)
    return (iou > iou_threshold) & lower


def nms_keep_reference(boxes_sorted: torch.Tensor,
                       scores_sorted: torch.Tensor,
                       iou_threshold: float = 0.45,
                       max_iters: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch greedy keep mask: (B, K, 4) xyxy f32 boxes sorted by
    score, (B, K) f32 scores (<= 0 invalid) -> (B, K) bool.

    Box i is suppressed iff some higher-ranked *kept* box overlaps it with
    IoU > threshold; the wave runs to fixpoint (at most K sweeps, the
    deepest possible chain), which is the exact greedy keep-set."""
    K = scores_sorted.shape[-1]
    if max_iters is None:
        max_iters = K
    overlap = overlap_matrix(boxes_sorted, iou_threshold)
    invalid = scores_sorted <= 0
    suppressed = invalid
    for _ in range(max_iters):
        active = ~suppressed & ~invalid
        new_sup = (overlap & active[:, None, :]).any(-1) | invalid
        if torch.equal(new_sup, suppressed):
            break
        suppressed = new_sup
    return ~suppressed & ~invalid


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """Words held as int64 in [0, 2^32) -> the same bits as int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


def overlap_words_reference(boxes_sorted: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """The build kernel's mask in plain PyTorch: (B, K, W = ceil(K/32))
    int32 words, bit l of ``[b, i, w]`` set when box j = 32w + l (j > i)
    overlaps box i, i.e. ``overlap_matrix[b, j, i]``."""
    B, K = boxes_sorted.shape[:2]
    W = -(-K // 32)
    upper = torch.zeros(B, K, 32 * W, dtype=torch.int64,
                        device=boxes_sorted.device)
    upper[:, :, :K] = overlap_matrix(boxes_sorted,
                                     iou_threshold).transpose(1, 2)
    shifts = torch.arange(32, device=upper.device)
    return _to_int32((upper.view(B, K, W, 32) << shifts).sum(-1))


def walk_words_reference(words: torch.Tensor,
                         scores_sorted: torch.Tensor) -> torch.Tensor:
    """The walk kernel's block-wise greedy in plain PyTorch: (B, K, W)
    int32 mask words (only those at or right of the diagonal are read) and
    (B, K) scores -> (B, K) bool keep.

    ``removed`` holds a word a block. Block w resolves box by box against
    its diagonal words (a box is kept when valid and not removed, and then
    removes what its diagonal word marks); then the kept boxes' words right
    of the block are ORed into ``removed``."""
    B, K = scores_sorted.shape
    W = words.shape[-1]
    mask = words.to(torch.int64) & 0xFFFFFFFF
    valid = scores_sorted > 0
    removed = torch.zeros(B, W, dtype=torch.int64, device=words.device)
    keep = torch.zeros(B, K, dtype=torch.bool, device=words.device)
    for w in range(W):
        rows = range(32 * w, min(32 * w + 32, K))
        r = removed[:, w]
        for b, i in enumerate(rows):
            kept = valid[:, i] & ((r >> b) & 1 == 0)
            r = torch.where(kept, r | mask[:, i, w], r)
            keep[:, i] = kept
        for i in rows:
            removed[:, w + 1:] |= torch.where(keep[:, i, None],
                                              mask[:, i, w + 1:], 0)
    return keep


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    from tpucv_torch import _build

    return typed(_build.load("nms"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of csrc/nms.cu with its entry points typed (untyped, ctypes
    would pass each pointer as a 32-bit int)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpucv_nms_keep.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, ptr]
    lib.tpucv_nms_build.argtypes = [ptr, ptr, i32, i32, f32, ptr]
    lib.tpucv_nms_walk.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.tpucv_nms_plan.argtypes = [i32, i32,
                                   ctypes.POINTER(ctypes.c_longlong)]
    lib.tpucv_nms_plan.restype = None
    for fn in (lib.tpucv_nms_keep, lib.tpucv_nms_build, lib.tpucv_nms_walk):
        fn.restype = ctypes.c_int
    lib.tpucv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpucv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2 \
            or boxes.shape[:2] != scores.shape:
        raise ValueError(f"nms_keep wants boxes (B, K, 4) and scores (B, K), "
                         f"got {tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_keep wants float32, got {boxes.dtype} and "
                        f"{scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_keep wants contiguous boxes and scores")


def _on_card(what: str, B: int, K: int, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {dev}")
    if K > MAX_BOXES:
        raise ValueError(f"{what} kernel takes K <= {MAX_BOXES}, got {K}")


def _launch(what: str, fn, dev: torch.device, *args) -> None:
    """Call a C entry point with the current stream last; raise on the
    error it returns."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{_lib().tpucv_cuda_error_string(err).decode()}")


def nms_keep(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
             iou_threshold: float = 0.45) -> torch.Tensor:
    """Greedy keep mask (B, K) bool over score-sorted candidates.

    CUDA tensors launch ``csrc/nms.cu``'s build and walk (K <= 1024) on
    the current stream, over a scratch mask of ``nms_plan(B, K)``, and count
    one launch a call in ``nms_keep.launches``; CPU tensors run
    ``nms_keep_reference``. Any other input raises."""
    _check(boxes_sorted, scores_sorted)
    dev = boxes_sorted.device
    if dev.type == "cpu":
        return nms_keep_reference(boxes_sorted, scores_sorted, iou_threshold)
    B, K = scores_sorted.shape
    _on_card("nms_keep", B, K, dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return keep
    words = _scratch(nms_plan(B, K), B, dev)
    _launch(f"nms_keep (B={B}, K={K})", _lib().tpucv_nms_keep, dev,
            boxes_sorted.data_ptr(), scores_sorted.data_ptr(),
            words.data_ptr(), keep.data_ptr(), B, K, float(iou_threshold))
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def overlap_words(boxes_sorted: torch.Tensor,
                  iou_threshold: float = 0.45) -> torch.Tensor:
    """The mask build alone: (B, K, ceil(K/32)) int32 words, zero left of
    the diagonal. CUDA tensors launch the build kernel (counted in
    ``overlap_words.launches``); CPU tensors run
    ``overlap_words_reference``."""
    if boxes_sorted.dim() != 3 or boxes_sorted.shape[-1] != 4 \
            or boxes_sorted.dtype != torch.float32 \
            or not boxes_sorted.is_contiguous():
        raise ValueError("overlap_words wants contiguous (B, K, 4) float32 "
                         f"boxes, got {tuple(boxes_sorted.shape)} "
                         f"{boxes_sorted.dtype}")
    dev = boxes_sorted.device
    if dev.type == "cpu":
        return overlap_words_reference(boxes_sorted, iou_threshold)
    B, K = boxes_sorted.shape[:2]
    _on_card("overlap_words", B, K, dev)
    p = nms_plan(B, K)
    words = _scratch(p, B, dev, zero=True)
    if B and K:
        _launch(f"overlap_words (B={B}, K={K})", _lib().tpucv_nms_build, dev,
                boxes_sorted.data_ptr(), words.data_ptr(), B, K,
                float(iou_threshold))
        overlap_words.launches += 1
    return words[:, :K, :p.words]


overlap_words.launches = 0


def walk_words(words: torch.Tensor,
               scores_sorted: torch.Tensor) -> torch.Tensor:
    """The walk alone over (B, K, ceil(K/32)) int32 mask words -> (B, K)
    bool keep. CUDA tensors launch the walk kernel (counted in
    ``walk_words.launches``); CPU tensors run ``walk_words_reference``."""
    B, K = scores_sorted.shape
    W = -(-K // 32)
    if words.shape != (B, K, W) or words.dtype != torch.int32 \
            or scores_sorted.dtype != torch.float32 \
            or not scores_sorted.is_contiguous() \
            or words.device != scores_sorted.device:
        raise ValueError(f"walk_words wants ({B}, {K}, {W}) int32 words and "
                         f"contiguous float32 scores on one device, got "
                         f"{tuple(words.shape)} {words.dtype}")
    dev = words.device
    if dev.type == "cpu":
        return walk_words_reference(words, scores_sorted)
    _on_card("walk_words", B, K, dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return keep
    padded = _scratch(nms_plan(B, K), B, dev, zero=True)
    padded[:, :K, :W] = words
    _launch(f"walk_words (B={B}, K={K})", _lib().tpucv_nms_walk, dev,
            padded.data_ptr(), scores_sorted.data_ptr(), keep.data_ptr(),
            B, K)
    walk_words.launches += 1
    return keep


walk_words.launches = 0


def timing_launchers(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
                     iou_threshold: float, lib: Optional[ctypes.CDLL] = None):
    """(build, walk): two calls that launch the build kernel and the walk
    kernel alone over one scratch mask, as ``nms_keep`` does, for timing
    them apart on the card (counted in ``overlap_words.launches`` and
    ``walk_words.launches``). Run ``build`` once before ``walk``. ``lib``:
    another ``typed`` build of csrc/nms.cu (the ablation probe's)."""
    _check(boxes_sorted, scores_sorted)
    B, K = scores_sorted.shape
    dev = boxes_sorted.device
    _on_card("timing_launchers", B, K, dev)
    words = _scratch(nms_plan(B, K), B, dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    lib = lib or _lib()

    def build():
        _launch("nms build", lib.tpucv_nms_build, dev,
                boxes_sorted.data_ptr(), words.data_ptr(), B, K,
                float(iou_threshold))
        overlap_words.launches += 1

    def walk():
        _launch("nms walk", lib.tpucv_nms_walk, dev, words.data_ptr(),
                scores_sorted.data_ptr(), keep.data_ptr(), B, K)
        walk_words.launches += 1
        return keep

    return build, walk


def cuda_nms(
    boxes: torch.Tensor,          # (B, N, 4) xyxy (any order)
    scores: torch.Tensor,         # (B, N)
    iou_threshold: float = 0.45,
    max_det: int = 300,
    presorted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full NMS: stable descending sort (skipped when ``presorted``), the
    kernel's keep mask, then the top ``max_det`` kept scores.

    Returns (indices (B, max_det) int32 into the input order,
    valid (B, max_det) bool)."""
    if presorted:
        order = None
        sb, ss = boxes, scores
    else:
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
        sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        ss = torch.gather(scores, 1, order)
    keep = nms_keep(sb, ss, iou_threshold)
    return select_kept(keep, ss, order, max_det)


def select_kept(keep, ss, order, max_det):
    """Top ``max_det`` kept candidates by score, lower index first on ties
    (``lax.top_k``'s order)."""
    keep_scores = torch.where(keep, ss, torch.full_like(ss, NEG_INF))
    top_scores, top_pos = torch.sort(keep_scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_pos = top_scores[:, :max_det], top_pos[:, :max_det]
    valid = top_scores > NEG_INF / 2
    idx = top_pos if order is None else torch.gather(order, 1, top_pos)
    return idx.to(torch.int32), valid
