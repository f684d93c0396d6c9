"""NMS inputs with known greedy outcomes, in numpy: the cases that hold the
NMS engines and the CUDA kernel against their references.

The random, chain and presorted cases are those of
``tests/test_pallas_nms.py``; the edge cases sit on the decision edges of
the IoU test; the block cases on the edges of the kernels' 32-box blocks;
the class-offset cases have decode's shape (boxes in a 640 image offset by
class * 7680, scores descending with an invalid tail); the SSD cases the
multilabel decode's (SSD300's K = 1,024 candidates: boxes in a 300 image,
the same box under several of 20 classes, offsets up to 19 * 7680 px,
where the f32 spacing is 1/64, and tied scores).
Every case is ``name -> ((boxes (B, N, 4) f32 xyxy, scores (B, N) f32),
iou_threshold)``.
"""

from __future__ import annotations

import numpy as np


def random_case(seed, n=128):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(5, 120, (n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)
    scores = rng.uniform(0.01, 1.0, n)
    return boxes.astype(np.float32)[None], scores.astype(np.float32)[None]


def chain(n_chain, N, step):
    """``n_chain`` boxes 2 px apart, each overlapping the next at IoU 2/3:
    greedy keeps every second box, a suppression chain ``n_chain`` deep."""
    boxes = np.zeros((1, N, 4), np.float32)
    scores = np.zeros((1, N), np.float32)
    for i in range(n_chain):
        boxes[0, i] = [i * 2.0, 0, i * 2.0 + 10.0, 10.0]
        scores[0, i] = 1.0 - i * step
    return boxes, scores


def presorted_case():
    rng = np.random.default_rng(5)
    B, N = 3, 96
    boxes = np.zeros((B, N, 4), np.float32)
    xy = rng.random((B, N, 2)).astype(np.float32) * 100
    wh = rng.random((B, N, 2)).astype(np.float32) * 40 + 5
    boxes[..., :2] = xy
    boxes[..., 2:] = xy + wh
    scores = -np.sort(-rng.random((B, N)).astype(np.float32), axis=-1)
    return boxes, scores


def class_offset_case(seed, B, K, n_cls=4, n_invalid=40):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 640, (B, K, 2))
    wh = rng.uniform(8, 160, (B, K, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    boxes += rng.integers(0, n_cls, (B, K, 1)) * 7680.0
    scores = -np.sort(-rng.uniform(0.25, 1.0, (B, K)), -1)
    scores[:, K - n_invalid:] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def ssd_offset_case(seed, B, K=1024, nc=20, n_anchors=400, n_invalid=60):
    """SSD's multilabel candidates, presorted: K (anchor, class) pairs drawn
    from ``n_anchors`` boxes in a 300 px image (clipped to it) and ``nc``
    classes, each box offset by class * 7680 px; scores descending in
    steps of 1/32 (many ties, their order the draw's), an invalid tail of
    ``n_invalid``."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 300, (B, n_anchors, 2))
    wh = rng.uniform(10, 150, (B, n_anchors, 2))
    anchors = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1),
                      0, 300).astype(np.float32)
    a = rng.integers(0, n_anchors, (B, K))
    cls = rng.integers(0, nc, (B, K)).astype(np.float32)
    boxes = np.take_along_axis(anchors, a[..., None], 1) + \
        cls[..., None] * np.float32(7680.0)
    scores = -np.sort(-rng.integers(1, 33, (B, K)) / 32.0, -1)
    scores[:, K - n_invalid:] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def ssd_cases():
    """SSD's K = 1,024 at the batches of its paths: predict (B=1), serve
    (B=8) and evaluate (B=32), IoU 0.5 as shipped."""
    return {f"ssd_offsets_B{B}_K1024": (ssd_offset_case(B + 13, B), 0.5)
            for B in (1, 8, 32)}


def edges(tiny):
    """Boxes on the decision edges, in groups far apart: with ``tiny``,
    identical 1e-3 px boxes whose IoU is 0.909 only through the 1e-7 in the
    union (threshold 0.95); otherwise a pair at IoU exactly 0.5 (kept: the
    test is strict) and an invalid box that would suppress the box after
    it if it counted."""
    if tiny:
        boxes = [[0, 0, 1e-3, 1e-3], [0, 0, 1e-3, 1e-3]]
    else:
        boxes = [[0, 0, 10, 10], [0, 0, 10, 5],
                 [200, 0, 210, 10], [206, 0, 216, 10], [208, 0, 218, 10]]
    scores = [0.9, 0.8, 0.5, 0.0, 0.3][:len(boxes)]
    return (np.asarray(boxes, np.float32)[None],
            np.asarray(scores, np.float32)[None])


def dense_case(seed, B, K):
    """K boxes crowded into a 100 px square, a tenth of them invalid: many
    overlaps, suppression chains across the 32-box blocks."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 100, (B, K, 2))
    wh = rng.uniform(15, 45, (B, K, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    scores = rng.uniform(0.01, 1.0, (B, K))
    scores[rng.random((B, K)) < 0.1] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def block_chain(start, n_chain, N, invalid=()):
    """``start`` isolated boxes, then a 2 px chain of ``n_chain`` (each
    overlapping the next at IoU 2/3), then isolated boxes up to N, scores
    descending; the boxes in ``invalid`` get score 0."""
    boxes = np.zeros((1, N, 4), np.float32)
    for i in range(N):
        k = i - start
        x = k * 2.0 if 0 <= k < n_chain else 1000.0 + 20.0 * i
        boxes[0, i] = [x, 0, x + 10.0, 10.0]
    scores = (1.0 - np.arange(N, dtype=np.float32) / (2 * N))[None]
    scores[0, list(invalid)] = 0.0
    return boxes, scores


def suppressed_block():
    """96 boxes: box 0 and the whole second block (32-63) are one square
    (the block's copies nudged by < 1 px), the rest isolated: greedy keeps
    box 0 and removes every box of block 1."""
    boxes, scores = block_chain(0, 0, 96)
    boxes[0, 0] = [0, 0, 100, 100]
    for i in range(32, 64):
        d = (i - 32) * 0.02
        boxes[0, i] = [d, d, 100 + d, 100 + d]
    return boxes, scores


def block_cases():
    """The walk's 32-box block edges: dense sets of K boxes at and around
    the block sizes, a chain that crosses two block boundaries, invalid
    boxes inside a chain's blocks, and a block that is wholly suppressed."""
    return {
        **{f"dense_K{K}": (dense_case(K, 2, K), 0.3)
           for K in (1, 31, 32, 33, 63, 64, 65, 77)},
        "cross_chain": (block_chain(20, 48, 96), 0.5),
        "invalid_in_chain": (block_chain(0, 64, 64, invalid=(5, 31, 32, 40)),
                          0.5),
        "suppressed_block": (suppressed_block(), 0.5),
    }


def greedy_cases():
    """The cases of ``tests/test_pallas_nms.py`` and the decision edges."""
    b10, b11 = random_case(10), random_case(11)
    return {
        **{f"seed{s}": (random_case(s), 0.5) for s in range(5)},
        "batched": ((np.concatenate([b10[0], b11[0]]),
                     np.concatenate([b10[1], b11[1]])), 0.5),
        "chain60": (chain(60, 64, 0.01), 0.5),
        "chain120": (chain(120, 128, 0.005), 0.5),
        "presorted": (presorted_case(), 0.5),
        "edges_iou0.5": (edges(False), 0.5),
        "edges_tiny_iou0.95": (edges(True), 0.95),
    }


def kernel_cases():
    """``greedy_cases``, ``block_cases`` and ``ssd_cases`` plus the kernel's
    own shapes: an odd K, and class-offset sets at the main path's B=128
    with K=512 and K=1024."""
    return {
        **greedy_cases(),
        **block_cases(),
        **ssd_cases(),
        "odd_K": (class_offset_case(9, 3, 77, n_cls=2, n_invalid=5), 0.45),
        **{f"offsets_B128_K{K}_iou{t}":
           (class_offset_case(K + int(t * 10), 128, K), t)
           for K in (512, 1024) for t in (0.5, 0.7)},
    }


def chain_keep(name):
    """The greedy keep list of a chain case, by its name (``chain60``)."""
    return list(range(0, int(name[len("chain"):]), 2))


def yolo_pred_case(seed, B, A, nc=80, n_obj=40, size=640.0):
    """YOLO decode output (B, A, 4+nc) f32 for ``non_max_suppression``:
    xywh boxes in a ``size`` image, clustered about ``n_obj`` objects an
    image (centres jittered by a tenth of the box: NMS has work),
    per-class scores in [0, 1), each anchor's object class drawn from
    U(0, 1) above a floor of U(0, 0.1) (so about a quarter stay under
    0.25). Ties on purpose: every 7th anchor takes
    anchor 0's scores, every 11th is its predecessor's exact copy (box and
    scores), and every 13th scores two classes equally best (the lower
    index wins)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.1 * size, 0.9 * size, (B, n_obj, 2))
    wh = rng.uniform(0.03 * size, 0.3 * size, (B, n_obj, 2))
    cls = rng.integers(0, nc, (B, n_obj))
    obj = rng.integers(0, n_obj, (B, A))
    bwh = wh[np.arange(B)[:, None], obj]
    xy = centre[np.arange(B)[:, None], obj] + rng.normal(0, 0.1, (B, A, 2)) * bwh
    bwh = bwh * rng.uniform(0.7, 1.3, (B, A, 2))
    scores = rng.uniform(0, 0.1, (B, A, nc))
    best = np.take_along_axis(cls, obj, 1)[..., None]
    np.put_along_axis(scores, best, rng.uniform(0, 1, (B, A, 1)), -1)
    pred = np.concatenate([xy, bwh, scores], -1).astype(np.float32)
    pred[:, ::7, 4:] = pred[:, :1, 4:]
    n = len(range(1, A, 11))
    pred[:, 1::11] = pred[:, 0:A - 1:11][:, :n]
    tie = pred[:, ::13, 4:]
    top = tie.argmax(-1)[..., None]
    np.put_along_axis(tie, (top + 1) % nc, np.take_along_axis(tie, top, -1),
                      -1)
    pred[:, ::13, 4:] = tie
    return pred
