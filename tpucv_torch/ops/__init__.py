"""Tensor ops: boxes, anchors, preprocessing, NMS, and the CUDA kernels
(greedy NMS, streaming add-one, narrow-channel 3x3 conv)."""
