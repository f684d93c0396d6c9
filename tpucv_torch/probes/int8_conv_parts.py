"""Where an int8 conv's time goes on the card: the stages of
``quant.quantized_conv`` at the largest convs of the bench program
(YOLOv8n, B=128, 640²), against ``F.conv2d`` in bf16 at the same shape.

Each shape runs the int8 path's own functions on a bf16 channels_last
input: ``quantize_activation``, ``int8_conv.im2col``,
``int8_conv.padded_gemm`` through ``int8_mm`` (``torch._int_mm``) and
``dequantize``, each timed alone (CUDA events), then the whole path
(``quantize_activation`` -> ``int8_conv`` -> ``dequantize``). The GEMM
route's int32 accumulators are first held bit-equal to the plain route's
(``conv_plain``). The bound is the int8 conv as a function: its bf16 input
read once and its bf16 output written once over 3.35 TB/s, or its int8
operations over 1,979 TOP/s, the larger.

    python -m tpucv_torch.probes.int8_conv_parts                 # the card
    python -m tpucv_torch.probes.int8_conv_parts --device cpu --small
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch
import torch.nn.functional as F

from tpucv_torch.ops.int8_conv import (conv_gemm, conv_plain, gemm_dims,
                                       im2col, int8_conv, int8_mm, int64_mm,
                                       out_hw, padded_gemm)
from tpucv_torch.probes.common import (H100_HBM_BYTES_PER_S, card, parser,
                                       resolve_device, timed)
from tpucv_torch.quant import dequantize, quantize_activation

H100_INT8_OPS = 1979e12          # dense int8 tensor cores, H100 SXM sheet

# (tag, B, H, W, cin, cout, k, stride): YOLOv8n's convs at B=128, 640²
# that move the most bytes on the int8 path, a 1x1, and the pose head's
# 51-wide keypoint convs (N and K padded to multiples of 8)
SHAPES = [
    ("model.22.cv3.0.1 80^2 80->80 3x3", 128, 80, 80, 80, 80, 3, 1),
    ("model.22.cv3.0.0 80^2 64->80 3x3", 128, 80, 80, 64, 80, 3, 1),
    ("model.1 320^2 16->32 3x3 s2", 128, 320, 320, 16, 32, 3, 2),
    ("model.2.m.0.cv1 160^2 16->16 3x3", 128, 160, 160, 16, 16, 3, 1),
    ("model.2.cv2 160^2 48->32 1x1", 128, 160, 160, 48, 32, 1, 1),
    ("pose cv4.0.1 80^2 51->51 3x3", 128, 80, 80, 51, 51, 3, 1),
]
SMALL = [(t, 2, max(4, h // 20), max(4, w // 20), ci, co, k, s)
         for t, _, h, w, ci, co, k, s in SHAPES]


def bound_ms(B, H, W, cin, cout, k, s) -> float:
    Ho, Wo = out_hw(H, W, (k, k), (s, s), (k // 2, k // 2), (1, 1))
    nbytes = 2 * B * H * W * cin + 2 * B * Ho * Wo * cout + k * k * cin * cout
    ops = 2 * B * Ho * Wo * k * k * cin * cout
    return max(nbytes / H100_HBM_BYTES_PER_S, ops / H100_INT8_OPS) * 1e3


def split(tag, B, H, W, cin, cout, k, s, dev: torch.device,
          n: int = 20, seed: int = 0) -> dict:
    """One shape's stages, timed, with its accumulators checked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, cin, H, W), generator=g, device=dev) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                       device=dev, dtype=torch.int8)
    w_bf16 = (torch.randn((cout, cin, k, k), generator=g, device=dev) * 0.1) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xscale = (x.abs().amax().float() / 127.0)
    qscale = torch.rand(cout, generator=g, device=dev) * 1e-3
    qbias = torch.randn(cout, generator=g, device=dev)
    geom = ((k, k), (s, s), (k // 2, k // 2), (1, 1))
    gemm = int8_mm if dev.type == "cuda" else int64_mm   # no int64 on CUDA
    xq = quantize_activation(x, xscale)
    a = im2col(xq, *geom)
    acc = conv_gemm(xq, wq, *geom, 1, gemm=gemm)
    same = torch.equal(acc, conv_plain(xq, wq, *geom, 1))
    if not same:
        raise RuntimeError(f"{tag}: GEMM route != plain route")
    M, K = a.shape
    stages = {
        "quantize": lambda: quantize_activation(x, xscale),
        "im2col": lambda: im2col(xq, *geom),
        "int_mm": lambda: padded_gemm(a, wq, gemm),
        "dequant": lambda: dequantize(acc, qscale, qbias, torch.bfloat16),
        "int8_total": lambda: dequantize(
            int8_conv(quantize_activation(x, xscale), wq, *geom, 1),
            qscale, qbias, torch.bfloat16),
        "conv2d_bf16": lambda: F.conv2d(x, w_bf16, None, s, k // 2),
    }
    with torch.inference_mode():
        ms = {name: timed(fn, n, dev) for name, fn in stages.items()}
    return {"shape": tag, "B": B, "M": M, "K": K, "N": cout,
            "padded": gemm_dims(M, K, cout) != (M, K, cout),
            "accumulators_equal": same, "ms": ms,
            "bound_ms": bound_ms(B, H, W, cin, cout, k, s),
            "int8_over_bf16": ms["int8_total"] / ms["conv2d_bf16"]}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    print(f"int8 conv stages on {card(dev)}", flush=True)
    rows = []
    for shape in (SMALL if args.small else SHAPES):
        row = split(*shape, dev=dev, n=2 if args.small else 20)
        print(f"{row['shape']:36s} " + " ".join(
            f"{k} {v:.4f}" for k, v in row["ms"].items())
            + f"  bound {row['bound_ms']:.4f} ms", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
