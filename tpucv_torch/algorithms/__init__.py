"""Algorithm façades (counterpart of ``tpucv.algorithms``); importing the
package registers them."""

from tpucv_torch.algorithms.yolov8 import YOLOv8  # noqa: F401
