"""int8 post-training quantization (PTQ) for inference (counterpart of
``tpucv/quant.py``).

The scheme is tpucv's, TensorRT's PTQ:
  * weights: BatchNorm (and any conv bias) folded into the kernel and a
    bias, then symmetric per-output-channel int8 (no zero points);
  * activations: symmetric per-tensor int8, the scale the running
    absolute maximum of the conv's input over the calibration batches;
  * the product accumulated in int32 (``ops/int8_conv.py``), then
    dequantized, biased and cast back to the activation's dtype.

Where tpucv returns its variables plus a ``quant`` collection, the port
returns a copy of the model whose quantized ``ConvBnAct``s hold four
buffers: ``qweight`` (cout, kh·kw·cin/g) int8, packed as the GEMM reads it
(``int8_conv.pack``), ``xscale`` () f32, ``qscale`` (cout,) f32 (weight
scale x ``xscale``) and ``qbias`` (cout,) f32, the folded bias. The float
weights stay in both models, so the float model still serves and a
quantized model's ``state_dict`` is the float one plus those buffers.
``ConvBnAct`` and ``HookedConv2d`` (``nn/blocks.py``, their shared
``Int8Hooks``) are the hooks: in eval mode each records its input while a
``calibrate`` pass runs and takes ``quantized_conv`` when it holds the
buffers; in train mode it always runs the float path. ``HookedConv2d`` is a
biased conv, paired with the BatchNorm after it (SSD's VGG: tpucv's
``conv_bn(use_bias=True)``, whose conv bias folds with the BN) or alone
(SSD's conv6 / conv7: tpucv's ``conv_biased``, a ``NO_BN`` pair whose bias
is the folded bias). The YOLO heads' final biased 1x1 convs, the DFL and
SSD's extras and heads stay float, as in tpucv.

Skips: convs whose per-group input width is below ``min_in_ch`` (the
3-channel stem, depthwise convs), convs whose calibrated absmax is not
finite and positive, and convs no calibration batch reached.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpucv_torch.ops.int8_conv import int8_conv, pack

MIN_IN_CH = 8
QUANT_BUFFERS = ("qweight", "xscale", "qscale", "qbias")
Stats = Dict[str, Tuple[float, float]]


class CalibrationSink:
    """One conv+BN pair's running input absmax (f32, on the device) and its
    BN epsilon as f32, tpucv's ``quant_stats`` entry."""

    def __init__(self):
        self.absmax: Optional[torch.Tensor] = None
        self.eps = 0.0

    def record(self, x: torch.Tensor, eps: float) -> None:
        m = x.detach().abs().amax().float()
        self.absmax = m if self.absmax is None else torch.maximum(
            self.absmax, m)
        self.eps = float(np.float32(eps))


def quantize_activation(x: torch.Tensor, xscale: torch.Tensor) -> torch.Tensor:
    """clip(round(x · (1/xscale)), ±127) as int8: the f32 reciprocal, then
    a product, rounding half to even, as tpucv does."""
    return torch.clamp(torch.round(x.float() * (1.0 / xscale)),
                       -127.0, 127.0).to(torch.int8)


def out_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the float conv would give: autocast's where it is on."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def dequantize(acc: torch.Tensor, qscale: torch.Tensor, qbias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``acc · qscale + qbias`` in f32 over NCHW int32, cast to ``dtype``."""
    y = acc.float() * qscale.view(1, -1, 1, 1) + qbias.view(1, -1, 1, 1)
    return y.to(dtype)


def quantized_conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The int8 path of one quantized ``ConvBnAct``: quantize ``x``, the
    int32 conv of ``module.conv``'s geometry, then dequantize to
    ``out_dtype(x)``. The PRE-activation output (NCHW)."""
    c = module.conv
    xq = quantize_activation(x, module.xscale)
    acc = int8_conv(xq, module.qweight, c.kernel_size, c.stride, c.padding,
                    c.dilation, c.groups)
    return dequantize(acc, module.qscale, module.qbias, out_dtype(x))


def hooked(model: nn.Module):
    """(qualified name, module) of every conv (+BN) pair with the hooks;
    each module has ``conv``, ``bn`` (None without BN) and the buffers."""
    from tpucv_torch.nn.blocks import Int8Hooks
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, Int8Hooks)]


def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> Stats:
    """Run the calibration batches through ``model`` in eval mode under
    ``torch.inference_mode`` (and whatever autocast the caller set), and
    return {qualified name: (input absmax, BN eps)} for each hooked pair a
    batch reached, the absmax reduced by max over the batches."""
    pairs = hooked(model)
    sinks = {name: CalibrationSink() for name, _ in pairs}
    was_training = model.training
    model.eval()
    n = 0
    try:
        for (_, m), sink in zip(pairs, sinks.values()):
            m.calibration = sink
        with torch.inference_mode():
            for x in batches:
                model(x)
                n += 1
    finally:
        for _, m in pairs:
            m.calibration = None
        model.train(was_training)
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    return {name: (float(s.absmax), s.eps) for name, s in sinks.items()
            if s.absmax is not None}


def quantize_convbn(weight, gamma, beta, mean, var, eps: float,
                    absmax: float, min_in_ch: int = MIN_IN_CH,
                    conv_bias=None):
    """Fold one conv+BN pair and quantize it, in float64 numpy in tpucv's
    order of operations (``_quantize_convbn``). ``weight`` is OIHW;
    ``conv_bias`` the conv's own bias, if it has one. ``gamma`` None is a
    conv without BN (tpucv's ``NO_BN`` pair): the kernel as it is, the
    conv bias (or 0) as the bias. Returns (qkernel OIHW int8, xscale f32,
    scale (cout,) f32, bias (cout,) f32), or None when the pair stays
    float."""
    kernel = np.asarray(weight, np.float64)
    if kernel.shape[1] < min_in_ch or not np.isfinite(absmax) or absmax <= 0:
        return None
    cbias = 0.0 if conv_bias is None else np.asarray(conv_bias, np.float64)
    if gamma is not None:
        gamma, beta, mean, var = (np.asarray(a, np.float64)
                                  for a in (gamma, beta, mean, var))
        f = gamma / np.sqrt(var + eps)
        w = kernel * f[:, None, None, None]
        bias = beta + (cbias - mean) * f
    else:
        w = kernel
        bias = np.broadcast_to(np.asarray(cbias, np.float64),
                               (kernel.shape[0],))
    wmax = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
    wscale = np.where(wmax > 0, wmax / 127.0, 1.0)
    qkernel = np.clip(np.round(w / wscale[:, None, None, None]),
                      -127, 127).astype(np.int8)
    xscale = float(absmax) / 127.0
    return (qkernel, np.float32(xscale), (wscale * xscale).astype(np.float32),
            bias.astype(np.float32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def set_quant_buffers(module: nn.Module, qkernel, xscale, scale,
                      bias) -> None:
    """Give one ``ConvBnAct`` its int8 buffers, on its weight's device."""
    dev = module.conv.weight.device
    module.qweight = pack(torch.from_numpy(np.asarray(qkernel))).to(dev)
    module.xscale = torch.tensor(np.float32(xscale), device=dev)
    module.qscale = torch.from_numpy(np.asarray(scale, np.float32)).to(dev)
    module.qbias = torch.from_numpy(np.asarray(bias, np.float32)).to(dev)


def quantize_for_inference(model: nn.Module,
                           calib_batches: Iterable[torch.Tensor], *,
                           min_in_ch: int = MIN_IN_CH) -> nn.Module:
    """One-call PTQ: calibrate ``model`` on ``calib_batches`` (model-input
    batches, under the caller's autocast) and return a copy whose
    quantizable pairs hold their int8 buffers. ``model`` is not changed."""
    stats = calibrate(model, calib_batches)
    qmodel = copy.deepcopy(model)
    for name, m in hooked(qmodel):
        if name not in stats:
            continue
        absmax, eps = stats[name]
        bn, c = m.bn, m.conv
        bn_args = ((None,) * 4 if bn is None else
                   (_numpy(bn.weight), _numpy(bn.bias),
                    _numpy(bn.running_mean), _numpy(bn.running_var)))
        entry = quantize_convbn(
            _numpy(c.weight), *bn_args, eps, absmax, min_in_ch,
            None if c.bias is None else _numpy(c.bias))
        if entry is not None:
            set_quant_buffers(m, *entry)
    return qmodel


def count_quantized(model: nn.Module) -> int:
    """Number of convs on the int8 path."""
    return sum(1 for _, m in hooked(model) if m.qweight is not None)
