"""The port's on-device augmentation against tpucv's, on the CPU in f32.

``tpucv_torch.ops.augment.augment_batch`` is held against tpucv's jitted
``augment_batch`` on the same uint8 batch and the same parameters (drawn
from a numpy seed, as the trainers draw them):

- pixels within 1e-6 (measured up to 7.3e-7 over six 8x256² batches, 9%
  of values differing at all: XLA contracts a few products, e.g. in
  ``v * (1 - s * f)``, which the port computes as separate roundings);
- boxes within 1e-5 (measured equal);
- the gather indices exactly, including sources that land on .5, where
  ``torch.round`` and ``jnp.round`` both round half to even.

The geometry cases of ``tests/test_augment.py`` (identity, shift, flip,
flip with scale) run against the port as they run against tpucv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.ops import augment as j_aug
from tpucv_torch.ops import augment as t_aug

torch.set_num_threads(1)
PIXEL_TOL, BOX_TOL = 1e-6, 1e-5


def host_params(rng, B, S, flip=None):
    """Parameters as the trainers draw them on the host."""
    scale = rng.uniform(0.5, 1.5, B).astype(np.float32)
    shift = (rng.random((B, 2)).astype(np.float32)
             * np.maximum(S * (1.0 - scale), 0.0)[:, None])
    fl = rng.random(B) < 0.5 if flip is None else np.full(B, flip)
    hsv = (1.0 + (rng.random((B, 3)) * 2 - 1)
           * np.array([0.1, 0.7, 0.4])).astype(np.float32)
    return scale, shift.astype(np.float32), fl, hsv


@jax.jit
def _j_run(images, boxes, scale, shift, flip, hsv):
    return j_aug.augment_batch(images, boxes,
                               j_aug.AffineParams(scale, shift, flip, hsv),
                               dtype=jnp.float32)


def run_both(images, boxes, params):
    ji, jb = _j_run(images, boxes, *params)
    ti, tb = t_aug.augment_batch(
        torch.from_numpy(images), torch.from_numpy(boxes),
        t_aug.AffineParams(*(torch.from_numpy(np.asarray(p))
                             for p in params)), dtype=torch.float32)
    assert ti.dtype == torch.float32 and tb.dtype == torch.float32
    return (np.asarray(ji), np.asarray(jb)), (ti.numpy(), tb.numpy())


@pytest.mark.parametrize("seed,B,S", [(0, 8, 64), (1, 4, 96), (2, 2, 80),
                                      (3, 8, 72)])
def test_augment_matches_tpucv(seed, B, S):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, S, S, 3), np.uint8)
    if seed % 2:                      # flat colours: HSV's ill-conditioned
        images[:, ::2] = images[:, ::2, :, :1]
    xy = rng.random((B, 5, 2)) * S * 0.7
    boxes = np.concatenate([xy, xy + rng.random((B, 5, 2)) * S * 0.5],
                           -1).astype(np.float32)
    (ji, jb), (ti, tb) = run_both(images, boxes, host_params(rng, B, S))
    assert np.abs(ji - ti).max() <= PIXEL_TOL
    assert np.abs(jb - tb).max() <= BOX_TOL


def _index_image(B, S):
    """Each pixel holds its source column and row, so the gathered values
    show which source was taken."""
    yy, xx = np.mgrid[0:S, 0:S]
    img = np.stack([xx, yy, np.zeros_like(xx)], -1).astype(np.uint8)
    return np.broadcast_to(img, (B, S, S, 3)).copy()


@pytest.mark.parametrize("flip", [False, True])
def test_half_sources_round_half_to_even(flip):
    """scale 2 and shift (0, 1): every odd column and every even row maps
    to a source at k + 0.5. The gathered columns and rows (HSV gains 1
    keep each channel; the hue round trip moves a value by under 1e-5)
    must be numpy's half-to-even rounding, on both sides."""
    B, S = 2, 64
    img = _index_image(B, S)
    params = (np.full(B, 2.0, np.float32), np.tile([[0.0, 1.0]], (B, 1))
              .astype(np.float32), np.full(B, flip), np.ones((B, 3),
                                                             np.float32))
    boxes = np.zeros((B, 1, 4), np.float32)
    (ji, _), (ti, _) = run_both(img, boxes, params)
    xs = np.arange(S, dtype=np.float32)
    src_x, src_y = xs / 2, (xs - 1) / 2
    assert (src_x % 1 == 0.5).sum() == S // 2
    ix = np.clip(np.round(src_x), 0, S - 1).astype(int)      # half to even
    iy = np.clip(np.round(src_y), 0, S - 1).astype(int)
    assert not np.array_equal(ix, np.floor(src_x + 0.5).astype(int))
    if flip:
        ix = S - 1 - ix
    for got in (ti, ji):
        vx = src_x <= S - 1
        vy = (src_y >= 0) & (src_y <= S - 1)
        cols = np.rint(got[0, vy][:, vx, 0] * 255)
        rows = np.rint(got[0, vy][:, vx, 1] * 255)
        np.testing.assert_array_equal(cols, np.broadcast_to(ix[vx], cols.shape))
        np.testing.assert_array_equal(
            rows, np.broadcast_to(iy[vy][:, None], rows.shape))
    assert np.abs(ji - ti).max() <= PIXEL_TOL


def _identity(B):
    return t_aug.AffineParams(torch.ones(B), torch.zeros(B, 2),
                              torch.zeros(B, dtype=torch.bool),
                              torch.ones(B, 3))


def test_identity_preserves_image_and_boxes():
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    img[0, 8:16, 4:12] = 200
    boxes = torch.tensor([[[4.0, 8.0, 12.0, 16.0]]])
    out, ob = t_aug.augment_batch(img, boxes, _identity(1),
                                  dtype=torch.float32)
    torch.testing.assert_close(ob, boxes)
    np.testing.assert_allclose(out[0, 12, 8].numpy(), [200 / 255] * 3,
                               atol=1e-5)


def test_shift_moves_content_and_boxes_together():
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    img[0, 0:8, 0:8] = 255
    boxes = torch.tensor([[[0.0, 0.0, 8.0, 8.0]]])
    p = t_aug.AffineParams(torch.ones(1), torch.tensor([[8.0, 4.0]]),
                           torch.zeros(1, dtype=torch.bool), torch.ones(1, 3))
    out, ob = t_aug.augment_batch(img, boxes, p, dtype=torch.float32)
    np.testing.assert_allclose(ob[0, 0].numpy(), [8, 4, 16, 12])
    assert float(out[0, 6, 10, 0]) > 0.9          # content followed the shift
    assert abs(float(out[0, 2, 2, 0]) - 128 / 255) < 1e-5   # vacated = fill


def test_flip_mirrors_boxes():
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    boxes = torch.tensor([[[0.0, 0.0, 8.0, 8.0]]])
    p = t_aug.AffineParams(torch.ones(1), torch.zeros(1, 2),
                           torch.ones(1, dtype=torch.bool), torch.ones(1, 3))
    _, ob = t_aug.augment_batch(img, boxes, p, dtype=torch.float32)
    np.testing.assert_allclose(ob[0, 0].numpy(), [24, 0, 32, 8])


def test_flip_with_scale_keeps_boxes_on_content():
    """Flip composed with scale keeps boxes on the gathered content (the
    flip happens in source space)."""
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    img[0, 8:16, 0:8] = 255
    boxes = torch.tensor([[[0.0, 8.0, 8.0, 16.0]]])
    p = t_aug.AffineParams(torch.full((1,), 0.5), torch.zeros(1, 2),
                           torch.ones(1, dtype=torch.bool), torch.ones(1, 3))
    out, ob = t_aug.augment_batch(img, boxes, p, dtype=torch.float32)
    np.testing.assert_allclose(ob[0, 0].numpy(), [12, 4, 16, 8], atol=1e-5)
    assert float(out[0, 5, 13, 0]) > 0.9
    outside = float(out[0, 5, 10, 0])
    assert abs(outside - 128 / 255) < 0.02 or outside < 0.1


def test_bf16_output_is_the_f32_result_rounded():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), np.uint8))
    boxes = torch.from_numpy(rng.random((2, 3, 4)).astype(np.float32) * 32)
    p = t_aug.AffineParams(*(torch.from_numpy(np.asarray(a))
                             for a in host_params(rng, 2, 32)))
    f32, b32 = t_aug.augment_batch(img, boxes, p, dtype=torch.float32)
    bf16, b16 = t_aug.augment_batch(img, boxes, p)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    assert torch.equal(b16, b32)


def test_hsv_roundtrip():
    rgb = torch.from_numpy(np.random.default_rng(0).random((4, 4, 3))
                           .astype(np.float32))
    back = t_aug._hsv_to_rgb(t_aug._rgb_to_hsv(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=1e-4)


@pytest.mark.parametrize("B,size", [(8, 64), (16, 640)])
def test_sampler_shapes_and_ranges(B, size):
    g = torch.Generator().manual_seed(0)
    p = t_aug.sample_affine_params(g, B, size)
    assert p.scale.shape == (B,) and p.shift.shape == (B, 2)
    assert p.flip.shape == (B,) and p.flip.dtype == torch.bool
    assert p.hsv.shape == (B, 3)
    assert ((p.scale >= 0.5) & (p.scale <= 1.5)).all()
    max_shift = (size * (1 - p.scale)).clamp(min=0)[:, None]
    assert ((p.shift >= 0) & (p.shift <= max_shift)).all()
    lo = torch.tensor([0.9, 0.3, 0.6])
    hi = torch.tensor([1.1, 1.7, 1.4])
    assert ((p.hsv >= lo) & (p.hsv <= hi)).all()
    again = t_aug.sample_affine_params(torch.Generator().manual_seed(0),
                                       B, size)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
