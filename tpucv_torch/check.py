"""Model-name whitelist (counterpart of ``tpucv/check.py``). It names the
families the port has so far; the others join as their slices land."""

MODELS = ["yolo8_det", "yolo8_seg", "yolo8_pose", "yolo7", "ssd",
          "centernet", "deeplabv3plus"]


def check_model_name(name: str) -> None:
    if name not in MODELS:
        raise ValueError(
            f"unknown model {name!r}; valid names: {MODELS}")
