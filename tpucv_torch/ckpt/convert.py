"""Carry tpucv's flax weights into the port (the inverse of
``tpucv.ckpt.importer.import_yolov8``).

tpucv names YOLOv8 modules ``b0..b9 / h12..h21 / detect``; the port keeps
ultralytics' ``model.{i}`` names, so the map below is the port's own copy
of tpucv's ``YOLOV8_LAYER_MAP``. Layouts: conv kernels HWIO -> OIHW; BN
``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``; the
frozen ``dfl_proj`` -> ``model.22.dfl.conv.weight`` (1, reg_max, 1, 1).

tpucv's segment and pose heads (``segment`` / ``pose``) nest the detect
branch one level down (``segment/detect/cv2_0_0``, ``pose/detect/dfl_proj``)
beside their own ``cv4_{lv}_{j}`` and ``proto``; the port's heads subclass
the detect head, so that level is dropped: ``model.22.cv2.0.0``,
``model.22.cv4.0.0``, ``model.22.proto.cv1``.

A ``quant`` collection (``tpucv/quant.py``) carries into the buffers of the
port's quantized ``ConvBnAct`` (``tpucv_torch/quant.py``):
``<scope>/conv::qkernel`` (HWIO int8) -> ``<module>.qweight``, packed
(cout, kh·kw·cin); ``xscale`` / ``scale`` / ``bias`` -> ``xscale`` /
``qscale`` / ``qbias`` as they are.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# ultralytics layer index -> tpucv module name
YOLOV8_LAYER_MAP = {
    0: "b0", 1: "b1", 2: "b2", 3: "b3", 4: "b4", 5: "b5", 6: "b6", 7: "b7",
    8: "b8", 9: "b9", 12: "h12", 15: "h15", 16: "h16", 18: "h18", 19: "h19",
    21: "h21", 22: "detect",
}
_TOP = {v: f"model.{k}" for k, v in YOLOV8_LAYER_MAP.items()}
_TOP.update(segment="model.22", pose="model.22")
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}
_HEAD_BRANCH = re.compile(r"^(cv[234])_(\d+)_(\d+)$")    # cv2_0_1 -> cv2.0.1
_REPEAT = re.compile(r"^m(\d+)$")                        # m0 -> m.0
_QUANT = {"conv::qkernel": "qweight", "conv::xscale": "xscale",
          "conv::scale": "qscale", "conv::bias": "qbias"}


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
    if top in ("segment", "pose") and mid[:1] == ["detect"]:
        mid = mid[1:]
    return ".".join([_TOP[top], *map(_part, mid), leaf])


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpucv ``{"params", "batch_stats"[, "quant"]}`` nested dicts of
    arrays -> the port's ``Yolo8`` ``state_dict`` (ultralytics key names,
    f32 tensors; the quant buffers int8 and f32), for any of its heads.
    Loads with ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _walk(variables.get(coll, {})):
            v = np.array(v, dtype=np.float32)
            if path[-1] == "dfl_proj":
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
    for path, v in _walk(variables.get("quant", {})):
        *mod, leaf = path
        name, t = quant_buffer(leaf, v)
        sd[_torch_name((*mod, name))] = t
    return sd


def quant_buffer(key: str, value) -> Tuple[str, torch.Tensor]:
    """One tpucv quant entry (``conv::qkernel`` etc.) -> the port's buffer
    name and tensor: the HWIO int8 kernel packed (cout, kh·kw·cin), the
    scales and the bias as they are."""
    v = np.array(value)                # a copy; xscale stays 0-d
    if key == "conv::qkernel":
        v = np.transpose(v, (3, 0, 1, 2)).reshape(v.shape[3], -1)
    return _QUANT[key], torch.from_numpy(v)
