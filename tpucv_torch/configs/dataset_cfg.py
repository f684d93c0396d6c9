"""Dataset configs (counterpart of ``tpucv/configs/dataset_cfg.py``): roots,
layouts and class lists of VOC and COCO.

Class order is part of every checkpoint, so both lists keep tpucv's order
exactly. The roots are overridable with the same environment variables as
tpucv's (``TPUCV_VOC_ROOT``, ``TPUCV_COCO_ROOT``), so one setting serves
both packages."""

import os

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

VOC_CFG = {
    "root": "/root/data/VOCdevkit/VOC2012",
    "images": "JPEGImages",
    "annotations": "Annotations",
    "classes": VOC_CLASSES,
    "num_classes": len(VOC_CLASSES),
}

COCO_CFG = {
    "root": "/root/data/COCO2017",
    "train_images": "train2017",
    "val_images": "val2017",
    "train_annotations": "annotations/instances_train2017.json",
    "val_annotations": "annotations/instances_val2017.json",
    "classes": COCO_CLASSES,
    "num_classes": len(COCO_CLASSES),
}

# COCO class index (0..79) -> official category id (1..90 with gaps)
COCO80_TO_COCO91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]


def get_dataset_cfg(name: str) -> dict:
    """The config of ``"voc"`` or ``"coco"``; the root is taken from
    ``TPUCV_<NAME>_ROOT`` when that is set."""
    cfg = dict({"voc": VOC_CFG, "coco": COCO_CFG}[name])
    env = os.environ.get(f"TPUCV_{name.upper()}_ROOT")
    if env:
        cfg["root"] = env
    return cfg
