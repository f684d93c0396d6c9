"""The stored FLOPs and the NMS's operation and byte count."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, flops, nms_cost


@pytest.mark.parametrize("name", ["yolov8l-coco640", "yolov7l-coco640"])
def test_stored_flops(name):
    cfg = common.load_json("configs", name)
    at_size = flops.count(cfg, cfg["input_size"])
    assert at_size == cfg["flops"]
    small = flops.count(cfg, 64)
    # every conv's work scales with its output's area: (640 / 64)^2
    for k, v in small.items():
        assert v * 100 == pytest.approx(at_size[k], rel=1e-9)


def test_nms_least_time_counts():
    # box 1 overlaps box 0 (suppressed after one test), box 2 overlaps
    # neither (tested against the one kept box above it), box 3 invalid
    boxes = torch.tensor([[[0., 0., 10., 10.], [1., 0., 11., 10.],
                           [50., 50., 60., 60.], [0., 0., 1., 1.]]])
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.0]])
    kept = nms_cost.keep(nms_cost.iou_above(boxes), scores, 0.5)
    assert kept.tolist() == [[True, False, True, False]]
    ops = 2 * nms_cost.IOU_OPS + 3 * nms_cost.AREA_OPS
    nbytes = 4 * (16 + 4 + 1)
    want = max(nbytes / common.H100_HBM_BYTES_PER_S,
               ops / common.H100_FP32_FLOPS)
    assert nms_cost.least_s(boxes, scores, 0.5) == pytest.approx(want)


def test_nms_keep_is_greedy():
    # a chain: 0 suppresses 1, so 2 (overlapping 1 only) survives
    boxes = torch.tensor([[[0., 0., 10., 10.], [4., 0., 14., 10.],
                           [8., 0., 18., 10.]]])
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    kept = nms_cost.keep(nms_cost.iou_above(boxes), scores, 0.3)
    assert kept.tolist() == [[True, False, True]]
