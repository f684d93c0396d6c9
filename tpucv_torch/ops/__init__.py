"""Tensor ops: boxes, anchors, preprocessing, NMS, and the CUDA kernels
(greedy NMS, streaming add-one, narrow-channel 3x3 conv).

Importing the package registers the ``tpucv::nms_keep`` (``cuda_nms``)
and ``tpucv::nms_scan`` (``cuda_scan``) operators, which a program loaded
by ``deploy.load_serialized`` calls."""

from tpucv_torch.ops import cuda_nms  # noqa: F401  (registers tpucv::nms_keep)
from tpucv_torch.ops import cuda_scan  # noqa: F401  (registers tpucv::nms_scan)
