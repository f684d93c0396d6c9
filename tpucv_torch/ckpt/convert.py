"""Carry tpucv's flax weights into the port (the inverse of
``tpucv.ckpt.importer.import_yolov8``).

tpucv names YOLOv8 modules ``b0..b9 / h12..h21 / detect``; the port keeps
ultralytics' ``model.{i}`` names, so the map below is the port's own copy
of tpucv's ``YOLOV8_LAYER_MAP``. Layouts: conv kernels HWIO -> OIHW; BN
``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``; the
frozen ``dfl_proj`` -> ``model.22.dfl.conv.weight`` (1, reg_max, 1, 1).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# ultralytics layer index -> tpucv module name
YOLOV8_LAYER_MAP = {
    0: "b0", 1: "b1", 2: "b2", 3: "b3", 4: "b4", 5: "b5", 6: "b6", 7: "b7",
    8: "b8", 9: "b9", 12: "h12", 15: "h15", 16: "h16", 18: "h18", 19: "h19",
    21: "h21", 22: "detect",
}
_TOP = {v: f"model.{k}" for k, v in YOLOV8_LAYER_MAP.items()}
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}
_HEAD_BRANCH = re.compile(r"^(cv[23])_(\d+)_(\d+)$")     # cv2_0_1 -> cv2.0.1
_REPEAT = re.compile(r"^m(\d+)$")                        # m0 -> m.0


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _part(p: str) -> str:
    m = _HEAD_BRANCH.match(p)
    if m:
        return ".".join(m.groups())
    m = _REPEAT.match(p)
    return f"m.{m.group(1)}" if m else p


def _torch_name(path) -> str:
    top, *mid, leaf = path
    return ".".join([_TOP[top], *map(_part, mid), leaf])


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpucv ``{"params", "batch_stats"}`` nested dicts of arrays -> the
    port's ``Yolo8`` ``state_dict`` (ultralytics key names, f32 tensors).
    Loads with ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _walk(variables.get(coll, {})):
            v = np.array(v, dtype=np.float32)
            if path == ("detect", "dfl_proj"):
                sd["model.22.dfl.conv.weight"] = torch.from_numpy(
                    v.reshape(1, -1, 1, 1))
                continue
            *mod, leaf = path
            if v.ndim == 4:                                   # HWIO -> OIHW
                v = np.transpose(v, (3, 2, 0, 1))
            name = _torch_name((*mod, _LEAF[(coll, leaf)]))
            sd[name] = torch.from_numpy(np.ascontiguousarray(v))
            if leaf == "mean":
                sd[name.replace("running_mean", "num_batches_tracked")] = \
                    torch.tensor(0)
    return sd
