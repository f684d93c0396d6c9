"""On-device augmentation (counterpart of ``tpucv/ops/augment.py``).

The host ships one uint8 batch and per-sample random parameters; one call
applies affine placement (a nearest-sample gather), horizontal flip, HSV
jitter and normalisation on the batch's device, as plain tensor ops (tpucv
computes it outside any Pallas kernel too). Box coordinates transform with
the same parameters.

Each step keeps the arithmetic of tpucv's jitted function, so the CPU
results agree with tpucv's to rounding: ``(x - shift) / scale`` in f32 and
in that order, then ``torch.round`` (half to even, as ``jnp.round``), so
the gather indices are equal; a division by a constant is a product with
its f32 reciprocal, as XLA compiles it (``/ 255``, ``/ 6``); ``%`` is
floor-mod in both; the HSV-to-RGB ``torch.where`` chain nests in
``jnp.select``'s order (the first true branch wins).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class AffineParams(NamedTuple):
    scale: torch.Tensor      # (B,) resize scale
    shift: torch.Tensor      # (B, 2) placement offset (x, y) px
    flip: torch.Tensor       # (B,) bool
    hsv: torch.Tensor        # (B, 3) gains (h, s, v)


def sample_affine_params(
    generator: torch.Generator, batch: int, size: int,
    scale_range: Tuple[float, float] = (0.5, 1.5),
    hgain: float = 0.1, sgain: float = 0.7, vgain: float = 0.4,
) -> AffineParams:
    """Per-sample parameters drawn from ``generator``, on its device: scale
    uniform in ``scale_range``, a shift that keeps the placed image on the
    canvas, a fair coin for the flip and HSV gains in ``1 ± gain``."""
    kw = dict(generator=generator, device=generator.device)
    lo, hi = scale_range
    scale = torch.rand(batch, **kw) * (hi - lo) + lo
    max_shift = (size * (1.0 - scale)).clamp(min=0.0)
    shift = torch.rand((batch, 2), **kw) * max_shift[:, None]
    flip = torch.rand(batch, **kw) < 0.5
    gains = torch.tensor([hgain, sgain, vgain], device=generator.device)
    hsv = 1.0 + (torch.rand((batch, 3), **kw) * 2 - 1) * gains
    return AffineParams(scale, shift, flip, hsv)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    d = mx - mn + 1e-8
    h = torch.where(
        mx == r, (g - b) / d % 6.0,
        torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) * (1 / 6.0)
    s = d / (mx + 1e-8)
    return torch.stack([h, s, mx], dim=-1)


def _select(i: torch.Tensor, branches) -> torch.Tensor:
    """``jnp.select([i == 0, ..., i == 5], branches)``: the first true
    condition wins, 0 where none holds."""
    out = torch.zeros_like(branches[0])
    for k in reversed(range(len(branches))):
        out = torch.where(i == k, branches[k], out)
    return out


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32) % 6
    r = _select(i, [v, q, p, p, t, v])
    g = _select(i, [t, v, v, q, p, p])
    b = _select(i, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def source_indices(params: AffineParams, S: int):
    """The inverse map of the placement: output pixel (y, x) of image b
    takes source pixel (iy[b, y], ix[b, x]), the nearest sample of
    ``((x, y) - shift) / scale`` with x flipped in source space; ``valid``
    (B, S, S) is False where the source falls outside the image (fill)."""
    xs = torch.arange(S, dtype=torch.float32, device=params.scale.device)
    src_x = (xs[None, :] - params.shift[:, 0:1]) / params.scale[:, None]
    src_y = (xs[None, :] - params.shift[:, 1:2]) / params.scale[:, None]
    in_x = (src_x >= 0) & (src_x <= S - 1)
    in_y = (src_y >= 0) & (src_y <= S - 1)
    ix = torch.round(src_x).clamp(0, S - 1).long()
    iy = torch.round(src_y).clamp(0, S - 1).long()
    ix = torch.where(params.flip[:, None], S - 1 - ix, ix)     # flip source x
    return iy, ix, in_y[:, :, None] & in_x[:, None, :]


def augment_batch(
    images_u8: torch.Tensor,     # (B, S, S, 3) uint8 (already letterboxed)
    boxes: torch.Tensor,         # (B, M, 4) xyxy px
    params: AffineParams,
    fill: float = 128.0 / 255.0,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply per-sample scale/shift/flip + HSV + normalise on the batch's
    device. Returns (images ``dtype`` in [0, 1], transformed boxes f32)."""
    B, S = images_u8.shape[0], images_u8.shape[1]
    iy, ix, valid = source_indices(params, S)

    # gather the uint8 pixels, then scale: the same values as tpucv's
    # gather of the scaled image, at a quarter of the bytes
    bi = torch.arange(B, device=images_u8.device)[:, None, None]
    g = images_u8[bi, iy[:, :, None], ix[:, None, :]]
    g = g.to(torch.float32) * (1 / 255.0)
    g = torch.where(valid[..., None], g, fill)

    # HSV jitter (vectorised; the reference uses uint8 LUTs, same effect)
    hsv = _rgb_to_hsv(g)
    gain = params.hsv[:, None, None, :]
    h = (hsv[..., 0] * gain[..., 0]) % 1.0
    s = (hsv[..., 1] * gain[..., 1]).clamp(0, 1)
    v = (hsv[..., 2] * gain[..., 2]).clamp(0, 1)
    g = _hsv_to_rgb(torch.stack([h, s, v], dim=-1))

    # boxes flip in source space first, then take the same scale + shift
    # (the gather flips SOURCE coordinates)
    fx = params.flip[:, None]
    src_x1 = torch.where(fx, S - boxes[..., 2], boxes[..., 0])
    src_x2 = torch.where(fx, S - boxes[..., 0], boxes[..., 2])
    src = torch.stack([src_x1, boxes[..., 1], src_x2, boxes[..., 3]], dim=-1)
    out_boxes = src * params.scale[:, None, None]
    sh = params.shift[:, None, :]
    out_boxes = out_boxes + torch.cat([sh, sh], dim=-1)
    out_boxes = out_boxes.clamp(0, S)
    return g.to(dtype), out_boxes
