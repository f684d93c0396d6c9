"""Algorithm façades (counterpart of ``tpucv.algorithms``); importing the
package registers them."""

from tpucv_torch.algorithms.yolov8 import YOLOv8  # noqa: F401
from tpucv_torch.algorithms.yolov8_pose import YOLOv8Pose  # noqa: F401
from tpucv_torch.algorithms.yolov8_seg import YOLOv8Seg  # noqa: F401
from tpucv_torch.algorithms.yolov7 import YOLOv7  # noqa: F401
from tpucv_torch.algorithms.ssd import Ssd  # noqa: F401
from tpucv_torch.algorithms.centernet import CenterNetA  # noqa: F401
from tpucv_torch.algorithms.segmentation_2d import DeeplabV3PlusA  # noqa: F401,E501
