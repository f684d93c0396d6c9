"""On-device preprocessing (counterpart of ``tpucv/ops/preprocess.py``).

uint8 NHWC batches go to the device once; letterbox, cast and scale run
there. ``host_letterbox_geom`` stays on the host in float64 so the resized
dims equal the reference host letterbox exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_images(images_u8: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC -> dtype in [0, 1]; the division runs in ``dtype``."""
    return images_u8.to(dtype) / torch.tensor(255.0, dtype=dtype,
                                              device=images_u8.device)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalisation over the last (channel) axis."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=images.dtype,
                        device=images.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=images.dtype,
                       device=images.device)
    return (images - mean) / std


def host_letterbox_geom(hw, out_size: int):
    """Exact letterbox geometry on the host in float64: scale =
    min(S/w, S/h), int-truncated new dims, //2 pads.

    hw: (B, 2) int array-like of (h, w). Returns (geom (B, 4) int32
    [nh, nw, top, left], scale (B,) f32) as numpy arrays."""
    hw = np.asarray(hw)
    h = hw[:, 0].astype(np.float64)
    w = hw[:, 1].astype(np.float64)
    S = float(out_size)
    scale = np.minimum(S / h, S / w)
    nh = (h * scale).astype(np.int64)          # int() truncation
    nw = (w * scale).astype(np.int64)
    top = (out_size - nh) // 2
    left = (out_size - nw) // 2
    geom = np.stack([nh, nw, top, left], axis=1).astype(np.int32)
    return geom, scale.astype(np.float32)


def letterbox_images(
    canvases_u8: torch.Tensor,   # (B, Hc, Wc, 3) uint8, image at top-left
    hw: torch.Tensor,            # (B, 2) int actual (h, w) per image
    out_size: int,
    fill: int = 128,
    geom: torch.Tensor | None = None,   # (B, 4) int32 from host_letterbox_geom
    scale: torch.Tensor | None = None,  # (B,) f32 from host_letterbox_geom
):
    """Batched letterbox on the tensors' device: aspect-preserving nearest
    resize of each valid (h, w) region onto an (S, S) canvas, centred,
    padded with ``fill``.

    Nearest source indices use the exact integer floor
    ``src = (dst - off) * len // new_len``, as tpucv does. Without
    ``geom``/``scale`` the geometry is computed in f32, which differs from
    the host float64 arithmetic by 1 px on some sizes.

    Returns (canvas uint8 (B, S, S, 3), scale (B,) f32, pad_xy (B, 2) f32).
    """
    S = out_size
    dev = canvases_u8.device
    B = canvases_u8.shape[0]
    hw = hw.to(dev, torch.int32)
    if geom is None or scale is None:
        hf = hw[:, 0].float()
        wf = hw[:, 1].float()
        # a tensor numerator: ``S / hf`` would run as S * (1 / hf), which
        # rounds differently from XLA's division
        s_ = hf.new_tensor(float(S))
        scale = torch.minimum(s_ / hf, s_ / wf)
        nh = torch.floor(hf * scale).to(torch.int32)
        nw = torch.floor(wf * scale).to(torch.int32)
        geom = torch.stack([nh, nw, (S - nh) // 2, (S - nw) // 2], 1)
    geom = geom.to(dev, torch.int32)
    scale = scale.to(dev, torch.float32)
    h, w = hw[:, 0:1], hw[:, 1:2]                          # (B, 1)
    nh, nw, top, left = (geom[:, i:i + 1] for i in range(4))
    r = torch.arange(S, dtype=torch.int32, device=dev)[None]   # (1, S)
    sy = torch.minimum(torch.clamp((r - top) * h // torch.clamp(nh, min=1),
                                   min=0), h - 1)
    sx = torch.minimum(torch.clamp((r - left) * w // torch.clamp(nw, min=1),
                                   min=0), w - 1)
    bi = torch.arange(B, device=dev)[:, None, None]
    out = canvases_u8[bi, sy.long()[:, :, None], sx.long()[:, None, :]]
    in_y = (r >= top) & (r < top + nh)                      # (B, S)
    in_x = (r >= left) & (r < left + nw)
    inside = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    out = torch.where(inside, out, torch.full_like(out, fill))
    pad = torch.cat([left, top], 1).to(torch.float32)
    return out, scale, pad


def letterbox_static(raw_u8: torch.Tensor, out_size: int, fill: int = 128):
    """Letterbox for a batch whose images share one (h, w) with
    max(h, w) == out_size: the resize is the identity and letterboxing is
    one centring pad.

    Returns (canvas uint8 (B, S, S, 3), scale=1.0, (pad_x, pad_y))."""
    B, h, w, _ = raw_u8.shape
    S = out_size
    if max(h, w) != S:
        raise ValueError(
            f"letterbox_static requires max(h,w)=={S}, got {(h, w)}; "
            f"use letterbox_images for the general case")
    py, px = (S - h) // 2, (S - w) // 2
    canvas = torch.nn.functional.pad(
        raw_u8, (0, 0, px, S - w - px, py, S - h - py), value=fill)
    return canvas, 1.0, (px, py)
