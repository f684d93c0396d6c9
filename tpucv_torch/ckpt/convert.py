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

tpucv's ``Yolo7`` tree (top-level ``stem0``, ``elan1``, ``mp1``, ...,
``rep{i}``, ``head{i}``) maps onto the reference network's names through
the port's copy of tpucv's ``YOLOV7_MODULE_MAP``: ``cv3_{i}`` ->
``cv3.{i}``, ``rep{i}/{dense,one}_{conv,bn}`` ->
``rep_conv_{i+1}.rbr_{dense,1x1}.{0,1}`` (``id_bn`` -> ``rbr_identity``;
at phi x ``rep{i}`` is a ConvBnAct, ``rep_conv_{i+1}.conv/.bn``) and
``head{i}`` -> ``yolo_head_P{i+3}``.

tpucv's ``SSD`` tree maps onto the reference's names as ``import_ssd``
reads them: ``vgg{k}_conv`` / ``vgg{k}_bn`` -> ``backbone.layers.{i}`` /
``.{i+1}`` (the k-th conv of VGG16-BN's layer list), ``conv6`` / ``conv7``
-> ``backbone.layers.44`` / ``.46``, ``l2norm/scale`` -> ``l2_norm.weight``,
``extra{j}`` -> ``extras.conv{j}``, ``loc{i}`` / ``conf{i}`` -> ``locs.{i}``
/ ``confs.{i}``; its quant entries (``vgg{k}_conv::qkernel``, at the
model's own scope) go to the buffers of the conv they name.

tpucv's ``CenterNet`` tree (top-level ``dla``, ``dla_up``, ``hm_0`` ...)
maps onto the reference's names as ``import_centernet`` reads them:
``dla`` -> ``backbone.base`` (``base`` -> ``base_layer``, ``level{i}`` ->
``level_{i}``), ``dla_up`` -> ``backbone.dla_up``; a ConvBNReLU's
``conv`` / ``bn`` -> ``.0`` / ``.1`` (a Root's keep their names), a
BasicBlock's ``cv1/{conv,bn}`` and ``cv2_{conv,bn}`` -> ``conv1/bn1`` and
``conv2/bn2``, a Tree's ``project_{conv,bn}`` -> ``project.{0,1}``; the
heads ``{hm,wh,reg}_{0,1}`` -> ``backbone.{heatmap,wh,reg}.{0,2}``. The
depthwise ``up_k`` kernels (k, k, 1, C) become ``ConvTranspose2d``'s
(C, 1, k, k) as any HWIO kernel does. Its quant buffers live on the
``HookedConv2d`` itself, so ``<scope>/conv::qkernel`` goes to
``<scope>.0.qweight`` (``conv1``, ``root.conv``).

tpucv's ``DeeplabV3Plus`` tree (top-level ``backbone``, ``aspp``,
``low_proj``, ``dec1``, ``classifier``) maps onto the reference's names
as ``import_deeplab`` reads them: ``backbone/stem`` -> ``backbone.conv1``
/ ``bn1``, ``backbone/layer{L}_{b}/cv{i}`` -> ``backbone.layer{L}.{b}``'s
``conv{i}`` / ``bn{i}`` and ``down`` -> ``downsample.{0,1}``;
``aspp/b{i}`` -> ``classifier.aspp.convs.{i}.{0,1}``, ``aspp/pool`` ->
``classifier.aspp.convs.4.{1,2}``, ``aspp/proj`` ->
``classifier.aspp.project.{0,1}``, ``low_proj`` ->
``classifier.project.{0,1}``, ``dec1`` -> ``classifier.classifier.{0,1}``
and the biased ``classifier`` -> ``classifier.classifier.3``. Its quant
buffers, as CenterNet's, live on the ``HookedConv2d``.

tpucv's ``ViT`` tree keeps its own names in the port (``patchify``,
``cls``, ``pos_embed``, ``block{i}/{ln1,attn,ln2,mlp}``, ``ln``, ``head``);
``cls`` and ``pos_embed`` are bare leaves, carried as they are. flax's
``Dense`` kernels are (in, out) and become ``nn.Linear``'s (out, in); the
attention's ``DenseGeneral`` kernels go flat: ``query`` / ``key`` /
``value`` (dim, H, hd) -> (H·hd, dim), ``out`` (H, hd, dim) -> (dim,
H·hd), their (H, hd) biases -> (H·hd,). YOLOv8-cls's ``classify`` head
(``conv``, ``linear``) is ``model.9``. tpucv's ``YoloV3`` tree (``c0``,
``down{s}``, ``res{s}_{r}``, ``y5_a0`` ...) keeps its names too.

The family is told by the tree's top-level names.
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
_TOP.update(segment="model.22", pose="model.22", classify="model.9")
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}
_HEAD_BRANCH = re.compile(r"^(cv[234])_(\d+)_(\d+)$")    # cv2_0_1 -> cv2.0.1
_REPEAT = re.compile(r"^m(\d+)$")                        # m0 -> m.0
_QUANT = {"conv::qkernel": "qweight", "conv::xscale": "xscale",
          "conv::scale": "qscale", "conv::bias": "qbias"}

# reference YOLOv7 module name -> tpucv Yolo7 module name
YOLOV7_MODULE_MAP = {
    "backbone.stem.0": "stem0", "backbone.stem.1": "stem1",
    "backbone.stem.2": "stem2", "backbone.dark2.0": "stem3",
    "backbone.dark2.1": "elan1", "backbone.dark3.0": "mp1",
    "backbone.dark3.1": "elan2", "backbone.dark4.0": "mp2",
    "backbone.dark4.1": "elan3", "backbone.dark5.0": "mp3",
    "backbone.dark5.1": "elan4",
    "conv_for_P5": "up1_conv", "conv_for_feat2": "p4_lat",
    "conv3_for_upsample1": "helan1",
    "conv_for_P4": "up2_conv", "conv_for_feat1": "p3_lat",
    "conv3_for_upsample2": "helan2",
    "down_sample1": "down1", "conv3_for_downsample1": "helan3",
    "down_sample2": "down2", "conv3_for_downsample2": "helan4",
}
_Y7_TOP = {v: k for k, v in YOLOV7_MODULE_MAP.items()}
_Y7_TOP.update(sppcspc="sppcspc",
               **{f"rep{i}": f"rep_conv_{i + 1}" for i in range(3)},
               **{f"head{i}": f"yolo_head_P{i + 3}" for i in range(3)})
_Y7_PART = {"dense_conv": "rbr_dense.0", "dense_bn": "rbr_dense.1",
            "one_conv": "rbr_1x1.0", "one_bn": "rbr_1x1.1",
            "id_bn": "rbr_identity"}
_ELAN_CONV = re.compile(r"^cv3_(\d+)$")                  # cv3_0 -> cv3.0

# tpucv SSD module name -> reference SSD module name: the VGG convs and
# BatchNorms at their slots in the ssd.pytorch layer list (a conv, its BN
# and its ReLU per conv; a pool after each block but the last)
_VGG_CONV_AT = [0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40]
_SSD_TOP = {"conv6": "backbone.layers.44", "conv7": "backbone.layers.46",
            "l2norm": "l2_norm"}
for _k, _i in enumerate(_VGG_CONV_AT):
    _SSD_TOP[f"vgg{_k}_conv"] = f"backbone.layers.{_i}"
    _SSD_TOP[f"vgg{_k}_bn"] = f"backbone.layers.{_i + 1}"
_SSD_HEAD = re.compile(r"^(extra|loc|conf)(\d+)$")
_SSD_PREFIX = {"extra": "extras.conv", "loc": "locs.", "conf": "confs."}

# tpucv CenterNet part -> reference part
_CN_HEAD = re.compile(r"^(hm|wh|reg)_([01])$")            # hm_1 -> heatmap.2
_CN_HEAD_NAME = {"hm": "heatmap", "wh": "wh", "reg": "reg"}
_CN_LEVEL = re.compile(r"^level(\d)$")                    # level3 -> level_3
_CN_PART = {"base": "base_layer", "project_conv": "project.0",
            "project_bn": "project.1", "cv2_conv": "conv2", "cv2_bn": "bn2"}


# tpucv DeepLab head part -> reference module, and the (conv, bn) slots
_DL_HEAD = {"aspp/pool": ("classifier.aspp.convs.4", "1", "2"),
            "aspp/proj": ("classifier.aspp.project", "0", "1"),
            "low_proj": ("classifier.project", "0", "1"),
            "dec1": ("classifier.classifier", "0", "1")}
_DL_BLOCK = re.compile(r"^layer(\d)_(\d+)$")           # layer3_22 -> layer3.22
_DL_ASPP = re.compile(r"^b(\d)$")                       # b2 -> convs.2


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


def _yolo7_name(path) -> str:
    top, *mid, leaf = path
    parts = []
    for p in mid:
        m = _ELAN_CONV.match(p)
        parts.append(f"cv3.{m.group(1)}" if m else _Y7_PART.get(p, p))
    return ".".join([_Y7_TOP[top], *parts, leaf])


def _ssd_name(path) -> str:
    top, *mid, leaf = path
    m = _SSD_HEAD.match(top)
    mod = _SSD_TOP[top] if m is None else _SSD_PREFIX[m[1]] + m[2]
    return ".".join([mod, *mid, leaf])


def _centernet_name(path) -> str:
    top, *mid, leaf = path
    m = _CN_HEAD.match(top)
    if m:
        return f"backbone.{_CN_HEAD_NAME[m[1]]}.{2 * int(m[2])}.{leaf}"
    parts = ["backbone", "base" if top == "dla" else "dla_up"]
    for k, p in enumerate(mid):
        parent = mid[k - 1] if k else None
        if p in ("conv", "bn") and parent == "cv1":
            parts[-1] = p + "1"                       # cv1 -> conv1 / bn1
        elif p in ("conv", "bn"):
            parts.append(p if parent == "root" else
                         "0" if p == "conv" else "1")
        else:
            lv = _CN_LEVEL.match(p)
            parts.append(f"level_{lv[1]}" if lv else _CN_PART.get(p, p))
    return ".".join([*parts, leaf])


def _deeplab_name(path) -> str:
    *mid, child, leaf = path
    if mid == []:                                   # the 1x1 classifier
        return f"classifier.classifier.3.{leaf}"
    if mid[0] == "backbone":
        if mid[1] == "stem":
            return f"backbone.{child}1.{leaf}"      # conv1 / bn1
        m = _DL_BLOCK.match(mid[1])
        block = f"backbone.layer{m[1]}.{m[2]}"
        if mid[2] == "down":
            return f"{block}.downsample.{0 if child == 'conv' else 1}.{leaf}"
        return f"{block}.{child}{mid[2][2:]}.{leaf}"  # cv2/bn -> bn2
    m = _DL_ASPP.match(mid[-1])
    if m:
        mod, conv, bn = f"classifier.aspp.convs.{m[1]}", "0", "1"
    else:
        mod, conv, bn = _DL_HEAD["/".join(mid)]
    return f"{mod}.{conv if child == 'conv' else bn}.{leaf}"


def _dense(mod, leaf: str, v: np.ndarray) -> np.ndarray:
    """A flax ``Dense`` / ``DenseGeneral`` leaf in ``nn.Linear``'s layout."""
    if leaf == "kernel" and v.ndim == 3:
        if mod[-1] == "out":                       # (H, hd, dim) -> (dim, H·hd)
            return v.reshape(-1, v.shape[-1]).T
        return v.reshape(v.shape[0], -1).T         # (dim, H, hd) -> (H·hd, dim)
    if leaf == "kernel" and v.ndim == 2:           # (in, out) -> (out, in)
        return v.T
    if leaf == "bias" and v.ndim == 2:             # (H, hd) -> (H·hd,)
        return v.reshape(-1)
    return v


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpucv ``{"params", "batch_stats"[, "quant"]}`` nested dicts of
    arrays -> the port's ``state_dict`` (f32 tensors; the quant buffers
    int8 and f32): ``Yolo8`` with any of its heads (ultralytics key names),
    ``Yolo7``, ``SSD``, ``CenterNet`` or ``DeeplabV3Plus`` (the
    reference's), or ``ViT`` or ``YoloV3`` (tpucv's). Loads with
    ``strict=True``."""
    top = variables.get("params", {})
    centernet = "dla" in top
    deeplab = "aspp" in top
    name_of = (_yolo7_name if "stem0" in top else
               _ssd_name if "vgg0_conv" in top else
               _centernet_name if centernet else
               _deeplab_name if deeplab else
               ".".join if "pos_embed" in top or "down0" in top else
               _torch_name)
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _walk(variables.get(coll, {})):
            v = np.array(v, dtype=np.float32)
            if path[-1] == "dfl_proj":
                sd["model.22.dfl.conv.weight"] = torch.from_numpy(
                    v.reshape(1, -1, 1, 1))
                continue
            if path in (("cls",), ("pos_embed",)):             # bare leaves
                sd[path[0]] = torch.from_numpy(v)
                continue
            *mod, leaf = path
            if v.ndim == 4:                                   # HWIO -> OIHW
                v = np.transpose(v, (3, 2, 0, 1))
            else:
                v = _dense(mod, leaf, v)
            name = name_of((*mod, _LEAF[(coll, leaf)]))
            sd[name] = torch.from_numpy(np.ascontiguousarray(v))
            if leaf == "mean":
                sd[name.replace("running_mean", "num_batches_tracked")] = \
                    torch.tensor(0)
    for path, v in _walk(variables.get("quant", {})):
        *mod, leaf = path
        conv, key = leaf.split("::")
        name, t = quant_buffer(f"conv::{key}", v)
        # a ConvBnAct holds its conv's buffers; any other conv (and every
        # CenterNet and DeepLab conv, a HookedConv2d) its own
        own = conv != "conv" or centernet or deeplab
        scope = [*mod, conv] if own else mod
        sd[name_of((*scope, name))] = t
    return sd


def quant_buffer(key: str, value) -> Tuple[str, torch.Tensor]:
    """One tpucv quant entry (``conv::qkernel`` etc.) -> the port's buffer
    name and tensor: the HWIO int8 kernel packed (cout, kh·kw·cin), the
    scales and the bias as they are."""
    v = np.array(value)                # a copy; xscale stays 0-d
    if key == "conv::qkernel":
        v = np.transpose(v, (3, 0, 1, 2)).reshape(v.shape[3], -1)
    return _QUANT[key], torch.from_numpy(v)
