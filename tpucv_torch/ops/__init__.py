"""Tensor ops: boxes, anchors, preprocessing, NMS and its CUDA kernel."""
