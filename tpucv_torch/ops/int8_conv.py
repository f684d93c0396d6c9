"""The int32 engine behind ``quant.quantized_conv``: a convolution of int8
activations with int8 weights, accumulated exactly in int32.

tpucv computes it with ``lax.conv_general_dilated`` on int8 operands and
``preferred_element_type=int32`` (``tpucv/quant.py:93-98``), which XLA
lowers itself; no Pallas kernel is involved. The port has two routes,
held equal bit for bit:

- ``conv_plain``, the plain version: ``F.conv2d`` in float64 on the
  int8-valued tensors, then int32. It is exact, since every product is an
  integer of at most 127² and every sum stays below 9·C·127² < 2⁵³.
- ``conv_gemm``, the card's route: the activation as an (M, K) int8
  matrix (NHWC rows; for a k×k or strided conv an im2col in the weight's
  (kh, kw, cin) order over int8 zero padding, exact because the
  quantization is symmetric), times the packed weight (N, K), through a
  GEMM that is an argument. On the card that GEMM is ``int8_mm``,
  ``torch._int_mm`` (cuBLASLt's int8 tensor-core product, int32 out),
  whose shapes must be M > 16 and K, N multiples of 8: ``gemm_dims`` pads
  each with zeros, which is exact, and the result is cut back.

``int8_conv`` takes the plain version only for a tensor on the CPU; on
CUDA it takes the GEMM route, and a failing library call raises.

The weight is kept packed, (N, K) = (cout, kh·kw·cin/groups) int8 with K
in (kh, kw, cin) order, so the GEMM reads it as it is; ``oihw`` unpacks
it for ``F.conv2d``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

Pair = Tuple[int, int]
Gemm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
MIN_ROWS = 17            # torch._int_mm on CUDA: M > 16
PAD_ROWS = 32            # what a shorter M is padded to
ALIGN = 8                # torch._int_mm on CUDA: K and N multiples of 8


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def gemm_dims(M: int, K: int, N: int) -> Tuple[int, int, int]:
    """(M, K, N) padded to what ``torch._int_mm`` takes on CUDA."""
    return (M if M >= MIN_ROWS else PAD_ROWS), _up(K, ALIGN), _up(N, ALIGN)


def pack(w_oihw: torch.Tensor) -> torch.Tensor:
    """(cout, cin/g, kh, kw) -> (cout, kh·kw·cin/g), K in (kh, kw, cin)
    order."""
    return w_oihw.permute(0, 2, 3, 1).reshape(w_oihw.shape[0], -1) \
        .contiguous()


def oihw(wq: torch.Tensor, kernel: Pair) -> torch.Tensor:
    """The packed weight back in (cout, cin/g, kh, kw)."""
    kh, kw = kernel
    return wq.view(wq.shape[0], kh, kw, -1).permute(0, 3, 1, 2)


def out_hw(h: int, w: int, kernel: Pair, stride: Pair, padding: Pair,
           dilation: Pair) -> Pair:
    return tuple((n + 2 * p - d * (k - 1) - 1) // s + 1 for n, k, s, p, d in
                 zip((h, w), kernel, stride, padding, dilation))


def conv_plain(xq: torch.Tensor, wq: torch.Tensor, kernel: Pair,
               stride: Pair, padding: Pair, dilation: Pair,
               groups: int) -> torch.Tensor:
    """The plain version: float64 ``F.conv2d`` of the int8 values, int32
    out (NCHW). cuDNN is kept out, so a CUDA input takes the im2col + DGEMM
    convolution, whose every product and partial sum is an exact integer."""
    with torch.backends.cudnn.flags(enabled=False), \
            torch.autocast(xq.device.type, enabled=False):
        y = F.conv2d(xq.double(), oihw(wq, kernel).double(), None, stride,
                     padding, dilation, groups)
    return y.to(torch.int32)


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)ᵀ int8 -> (M, N) int32 through cuBLASLt."""
    return torch._int_mm(a, w.t())


def int64_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same product in int64 (CPU only: CUDA has no int64 matmul),
    exact: the GEMM the CPU tests give ``conv_gemm`` to check its layout."""
    return (a.long() @ w.long().t()).to(torch.int32)


def padded_gemm(a: torch.Tensor, w: torch.Tensor, gemm: Gemm) -> torch.Tensor:
    """``gemm`` over ``a`` (M, K) and ``w`` (N, K) zero-padded to
    ``gemm_dims``, its (M, N) corner."""
    (M, K), N = a.shape, w.shape[0]
    Mp, Kp, Np = gemm_dims(M, K, N)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w = F.pad(w, (0, Kp - K, 0, Np - N))
    out = gemm(a, w)
    return out if (Mp, Np) == (M, N) else out[:M, :N]


def im2col(xq: torch.Tensor, kernel: Pair, stride: Pair, padding: Pair,
           dilation: Pair) -> torch.Tensor:
    """(B, C, H, W) int8 -> (B·Ho·Wo, kh·kw·C): the rows NHWC, each row's
    taps in (kh, kw, cin) order. A 1x1 stride-1 conv of a channels_last
    input needs no copy."""
    B, C, H, W = xq.shape
    ph, pw = padding
    x = xq.permute(0, 2, 3, 1)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    x = x.contiguous()
    if tuple(kernel) == (1, 1) and tuple(stride) == (1, 1):
        return x.view(-1, C)
    Ho, Wo = out_hw(H, W, kernel, stride, padding, dilation)
    sB, sH, sW, sC = x.stride()
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    return x.as_strided((B, Ho, Wo, kh, kw, C),
                        (sB, sh * sH, sw * sW, dh * sH, dw * sW, sC)) \
        .reshape(B * Ho * Wo, kh * kw * C)


def conv_gemm(xq: torch.Tensor, wq: torch.Tensor, kernel: Pair,
              stride: Pair, padding: Pair, dilation: Pair, groups: int,
              gemm: Gemm = int8_mm) -> torch.Tensor:
    """The GEMM route: int32 (B, N, Ho, Wo), channels_last in memory."""
    B, C, H, W = xq.shape
    Ho, Wo = out_hw(H, W, kernel, stride, padding, dilation)
    a = im2col(xq, kernel, stride, padding, dilation)
    N = wq.shape[0]
    if groups == 1:
        acc = padded_gemm(a, wq, gemm)
    else:
        taps, cg, ng = kernel[0] * kernel[1], C // groups, N // groups
        a = a.view(-1, taps, C)
        acc = torch.cat([padded_gemm(
            a[:, :, g * cg:(g + 1) * cg].reshape(-1, taps * cg),
            wq[g * ng:(g + 1) * ng], gemm) for g in range(groups)], 1)
    return acc.view(B, Ho, Wo, N).permute(0, 3, 1, 2)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, kernel: Pair,
              stride: Pair, padding: Pair, dilation: Pair,
              groups: int) -> torch.Tensor:
    """int32 accumulators of the int8 conv (NCHW): ``conv_gemm`` through
    ``int8_mm`` on CUDA, ``conv_plain`` on the CPU."""
    if xq.device.type == "cpu":
        return conv_plain(xq, wq, kernel, stride, padding, dilation, groups)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: no route for device {xq.device}")
    return conv_gemm(xq, wq, kernel, stride, padding, dilation, groups)
