"""Model-name whitelist (counterpart of ``tpucv/check.py``): tpucv's nine
registered families."""

MODELS = ["yolo8_det", "yolo8_seg", "yolo8_pose", "yolo8_cls", "yolo7",
          "ssd", "centernet", "deeplabv3plus", "vit_cls"]


def check_model_name(name: str) -> None:
    if name not in MODELS:
        raise ValueError(
            f"unknown model {name!r}; valid names: {MODELS}")
