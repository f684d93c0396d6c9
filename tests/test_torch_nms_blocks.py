"""The redesigned NMS and add_one kernels' algorithms, on the CPU.

``tpucv_torch/csrc/nms.cu`` builds a bit-packed overlap mask with many
CTAs an image, then walks it 32 boxes a step. Their plain twins,
``overlap_words_reference`` and ``walk_words_reference``, are held here
against tpucv's Pallas kernel (``pallas_nms_keep`` in interpret mode), a
sequential greedy in numpy f32 and ``nms_keep_reference``, on every case of
``tpucv_torch/ops/nms_cases.py`` small enough for the CPU, in score order
and, for the block cases, in the order given (invalid boxes inside a
chain's blocks). Keep masks must be identical and the mask words exact.
The launch plans of both kernels (grids, scratch and add_one's tail split)
are checked at the main path's shapes and against the constants of the
CUDA sources, and the ablation probes' edits against the sources. The kernels themselves are held against these twins in
``tests/test_torch_cuda.py``, on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.ops.pallas_nms import pallas_nms_keep
from tpucv_torch.ops.cuda_nms import (BUILD_THREADS, MAX_BOXES, RING_BLOCKS,
                                      WALK_THREADS, nms_keep_reference,
                                      nms_plan, overlap_matrix, overlap_words,
                                      overlap_words_reference, walk_words,
                                      walk_words_reference)
from tpucv_torch.ops.nms_cases import (block_cases, class_offset_case,
                                       greedy_cases)
from tpucv_torch.ops.stream import THREADS, stream_plan
from tpucv_torch.probes import nms_ablations, probe_bw, stream_ablations

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BLOCK_CASES = block_cases()
CASES = {**greedy_cases(), **BLOCK_CASES,
         "odd_K": (class_offset_case(9, 3, 77, n_cls=2, n_invalid=5), 0.45)}


def _sorted(boxes, scores):
    order = np.argsort(-scores, axis=-1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order, 1))


def _greedy(boxes, scores, thr):
    """Sequential greedy over the given order, the IoU in numpy f32 in the
    kernel's association."""
    keep = np.zeros(scores.shape, bool)
    f32 = np.float32
    for b in range(scores.shape[0]):
        x1, y1, x2, y2 = boxes[b].T
        area = np.maximum(x2 - x1, f32(0)) * np.maximum(y2 - y1, f32(0))
        removed = scores[b] <= 0
        for i in range(scores.shape[1]):
            if removed[i]:
                continue
            keep[b, i] = True
            ix = np.maximum(np.minimum(x2[i], x2) - np.maximum(x1[i], x1),
                            f32(0))
            iy = np.maximum(np.minimum(y2[i], y2) - np.maximum(y1[i], y1),
                            f32(0))
            inter = ix * iy
            iou = inter / (((area[i] + area) - inter) + f32(1e-7))
            later = np.arange(scores.shape[1]) > i
            removed |= later & (iou > f32(thr))
    return keep


def _walk(boxes, scores, thr):
    sb, ss = torch.from_numpy(boxes), torch.from_numpy(scores)
    return walk_words_reference(overlap_words_reference(sb, thr), ss).numpy()


def _pallas(boxes, scores, thr):
    return np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                      thr, interpret=True)) > 0.5


def _unpack(words, K):
    """(B, K, W) int32 words -> (B, K, 32W) bool bits."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> torch.arange(32)) & 1
    return bits.reshape(*words.shape[:2], -1).bool()


@pytest.mark.parametrize("name", list(CASES))
def test_overlap_words_unpack_to_the_overlap_matrix(name):
    """Bit l of word w of row i is overlap[j, i] for j = 32w + l > i; no
    bit is set at or left of the diagonal or past K."""
    (boxes, scores), thr = CASES[name]
    sb = torch.from_numpy(_sorted(boxes, scores)[0])
    K = sb.shape[1]
    words = overlap_words_reference(sb, thr)
    assert words.dtype == torch.int32
    assert words.shape == (sb.shape[0], K, nms_plan(1, K).words)
    bits = _unpack(words, K)
    assert torch.equal(bits[..., :K],
                       overlap_matrix(sb, thr).transpose(1, 2))
    assert not bits[..., K:].any()
    assert not bits[..., :K].tril().any()


@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_pallas_and_greedy(name):
    (boxes, scores), thr = CASES[name]
    boxes, scores = _sorted(boxes, scores)
    keep = _walk(boxes, scores, thr)
    np.testing.assert_array_equal(keep, _pallas(boxes, scores, thr))
    np.testing.assert_array_equal(keep, _greedy(boxes, scores, thr))
    np.testing.assert_array_equal(keep, nms_keep_reference(
        torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy())


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_walk_in_the_given_order(name):
    """Unsorted, so invalid boxes sit inside the blocks and chains: an
    invalid box neither keeps nor suppresses, wherever it is."""
    (boxes, scores), thr = BLOCK_CASES[name]
    keep = _walk(boxes, scores, thr)
    np.testing.assert_array_equal(keep, _greedy(boxes, scores, thr))
    np.testing.assert_array_equal(keep, _pallas(boxes, scores, thr))


@pytest.mark.parametrize("name,kept", [
    ("cross_chain", [*range(20), *range(20, 68, 2), *range(68, 96)]),
    ("suppressed_block", [*range(32), *range(64, 96)]),
    ("invalid_in_chain", [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28,
                       30, 33, 35, 37, 39, 41, 43, 45, 47, 49, 51, 53, 55, 57,
                       59, 61, 63]),
])
def test_block_edges_keep_what_greedy_keeps(name, kept):
    """A chain through boxes 20-67 crosses the boundaries at 32 and 64 and
    keeps every second box; box 0 removes the whole of block 1; in the order
    given, invalid boxes 31 and 32 cut the chain at the block boundary, so
    box 33 is kept (5 and 40 fall on boxes the chain removes anyway)."""
    (boxes, scores), thr = BLOCK_CASES[name]
    keep = _walk(boxes, scores, thr)
    assert np.flatnonzero(keep[0]).tolist() == kept


# -- the launch plans --------------------------------------------------------

def _constant(source, name):
    """A constexpr int of csrc/<source>, read from the source."""
    src = (REPO / "tpucv_torch" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("B,K,ctas,scratch", [
    (8, 1024, 256, 1 << 20),          # served: batch 8, pre_nms_topk 1024
    (128, 512, 2048, 4 << 20),        # bench.py:main: B=128, topk 512
    (128, 1024, 4096, 16 << 20),
    (3, 77, 9, 3 * 96 * 4 * 4),       # 77 boxes: 96 rows of 4 words
])
def test_nms_plan_at_the_main_path_shapes(B, K, ctas, scratch):
    p = nms_plan(B, K)
    assert p.words == -(-K // 32) and p.rows == 32 * p.words >= K
    # every row is whole 16-byte chunks, for the walk's cp.async
    assert p.row_words % 4 == 0 and 0 <= p.row_words - p.words < 4
    assert p.build_grid == (B, p.words)
    assert p.build_grid[0] * p.build_grid[1] == ctas
    assert p.walk_ctas == B
    assert p.scratch_bytes == B * p.rows * p.row_words * 4 == scratch


def test_nms_plan_constants_are_the_kernels():
    assert BUILD_THREADS == _constant("nms.cu", "kBuildThreads")
    assert WALK_THREADS == _constant("nms.cu", "kWalkThreads")
    assert RING_BLOCKS == _constant("nms.cu", "kRingBlocks")
    assert MAX_BOXES == _constant("nms.cu", "kMaxBoxes")
    # the build covers every row: CTA (img, c), warp k takes rows
    # c + W * (k + 8m), for every W up to 32
    for W in range(1, 33):
        rows = sorted(c + W * r for c in range(W)
                      for k in range(BUILD_THREADS // 32)
                      for r in range(k, 32, BUILD_THREADS // 32))
        assert rows == list(range(32 * W))


def _covers(n, p):
    return ((p.grid - 1) * p.threads + p.last_vectors) * 8 + \
        p.tail_elements == n


@pytest.mark.parametrize("n", [probe_bw.TOT * 128, probe_bw.SMALL_TOT * 128])
def test_stream_plan_at_the_probe_shapes(n):
    """The probe's array is whole chunks of 1,024 vectors: one CTA each."""
    p = stream_plan(n)
    assert p.threads == THREADS
    assert p.grid == n // (8 * THREADS) and p.last_vectors == THREADS
    assert p.tail_elements == 0 and _covers(n, p)
    assert p.index_bits == 32
    assert stream_plan(probe_bw.TOT * 128).grid == 25_600


@pytest.mark.parametrize("tail,grid,last_vectors", [
    (1, 3, THREADS), (7, 3, THREADS), (8, 4, 1), (9, 4, 1),
    (8 * THREADS - 1, 4, THREADS - 1), (8 * THREADS, 4, THREADS),
    (8 * THREADS + 1, 4, THREADS)])
def test_stream_plan_tail_split(tail, grid, last_vectors):
    """What follows whole chunks is the last CTA's: its vectors, then
    fewer than 8 elements (which a CTA of whole vectors takes too)."""
    n = 3 * 8 * THREADS + tail
    p = stream_plan(n)
    assert (p.grid, p.last_vectors, p.tail_elements) == \
        (grid, last_vectors, tail % 8)
    assert _covers(n, p)
    small = stream_plan(tail % (8 * THREADS) or 5)
    assert small.grid == 1 and _covers(tail % (8 * THREADS) or 5, small)


def test_stream_plan_index_width_and_the_kernels_threads():
    assert THREADS == _constant("stream.cu", "kThreads")
    big = 8 * (2 ** 32 - 1 - THREADS)
    assert stream_plan(big).index_bits == 32
    assert stream_plan(big + 8).index_bits == 64


# -- the wrappers on the CPU -------------------------------------------------

def test_check_entry_points_take_the_plain_twins_on_cpu():
    (boxes, scores), thr = CASES["dense_K65"]
    sb, ss = map(torch.from_numpy, _sorted(boxes, scores))
    before = (overlap_words.launches, walk_words.launches)
    words = overlap_words(sb, thr)
    assert torch.equal(words, overlap_words_reference(sb, thr))
    assert torch.equal(walk_words(words, ss), nms_keep_reference(sb, ss, thr))
    assert (overlap_words.launches, walk_words.launches) == before
    with pytest.raises(ValueError):
        walk_words(words[:, :, :-1], ss)
    with pytest.raises(ValueError):
        overlap_words(sb.double())


@pytest.mark.parametrize("name", list(nms_ablations.ABLATIONS))
def test_nms_ablation_edits_apply_to_the_kernel_source(name):
    """Each ablation finds the text it edits in csrc/nms.cu and changes
    the source."""
    src = (REPO / "tpucv_torch" / "csrc" / "nms.cu").read_text()
    assert nms_ablations._ablated_source(name) != src


def test_nms_ablations_run_on_the_card_only():
    with pytest.raises(SystemExit):
        nms_ablations.main(["--device", "cpu"])


@pytest.mark.parametrize("name", list(stream_ablations.ABLATIONS))
def test_stream_ablation_edits_apply_to_the_kernel_source(name):
    """Each edit finds the text it replaces in csrc/stream.cu, and the
    edited source still has one kernel and the plan's entry point."""
    src = (REPO / "tpucv_torch" / "csrc" / "stream.cu").read_text()
    edited = stream_ablations._ablated_source(name)
    assert edited != src
    assert edited.count("add_one_kernel(") == 1
    assert "void tpucv_add_one_plan(" in edited


def test_stream_ablations_run_on_the_card_only():
    with pytest.raises(SystemExit):
        stream_ablations.main(["--device", "cpu"])
