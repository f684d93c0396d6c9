"""The benchmark's plain reference: the networks, the detection pipeline,
YOLOv8's loss and the optimizer in float32 PyTorch, written from the
published models. It imports nothing of the measured program."""

from __future__ import annotations

import numpy as np


def build(cfg: dict):
    """The reference network of a configuration file (see
    ``benchmark/configs``), on the current default device."""
    net = cfg["network"]
    if net["family"] == "yolov8":
        from benchmark.reference.yolov8 import YOLOv8
        return YOLOv8(net["scale"], net["nc"], net["reg_max"])
    if net["family"] == "yolov7":
        from benchmark.reference.yolov7 import YOLOv7
        return YOLOv7(net["phi"], net["nc"], len(net["anchors"][0]))
    raise ValueError(f"no reference for family {net['family']!r}")


def dense(cfg: dict, raw):
    """Raw maps -> every anchor's (boxes xyxy input px, class scores)."""
    from benchmark.reference import detect
    net = cfg["network"]
    if net["family"] == "yolov8":
        return detect.dense_yolov8(raw, net["nc"], net["reg_max"],
                                   net["strides"])
    return detect.dense_yolov7(raw, net["nc"],
                               np.asarray(net["anchors"], np.float32),
                               net["strides"])
