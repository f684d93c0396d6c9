"""Dataset class lists (counterpart of ``tpucv/configs/dataset_cfg.py``).

Class order is part of every checkpoint, so both lists keep tpucv's order
exactly. Dataset roots arrive with the evaluation slice."""

VOC_CLASSES = [
    "person", "bird", "cat", "cow", "dog", "horse", "sheep", "aeroplane",
    "bicycle", "boat", "bus", "car", "motorbike", "train", "bottle",
    "chair", "diningtable", "pottedplant", "sofa", "tvmonitor",
]

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

_CLASSES = {"voc": VOC_CLASSES, "coco": COCO_CLASSES}


def get_dataset_cfg(name: str) -> dict:
    """``{"classes", "num_classes"}`` for ``"voc"`` or ``"coco"``."""
    classes = _CLASSES[name]
    return {"classes": classes, "num_classes": len(classes)}
