"""tpucv_torch's instance-mask ops against tpucv's ``ops/masks.py`` on the
same numpy-seeded prototypes, coefficients and boxes, in f32 on the CPU.

``crop_mask`` exactly; the prototype product and its sigmoid, alone or
with the bilinear resize (up 32 -> 128 and, in ``process_mask_native``,
down 32 -> 20 with antialiasing, as ``jax.image.resize`` does), within
2e-6 absolute; ``scale_image`` and ``masks2segments`` (host cv2) equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.ops import masks as jm
from tpucv_torch.ops import masks as tm

torch.set_num_threads(1)
TOL = 2e-6


def _inputs(seed=0, n=6, hp=32, wp=32, nm=8, s=128):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (hp, wp, nm)).astype(np.float32)
    coefs = rng.normal(0, 1, (n, nm)).astype(np.float32)
    xy = rng.uniform(0, s * 0.6, (n, 2))
    wh = rng.uniform(4, s * 0.4, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0] = [10.0, 12.0, 40.0, 41.0]          # integer edges
    return protos, coefs, boxes


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_crop_mask_exact():
    rng = np.random.default_rng(3)
    masks = rng.random((5, 20, 24)).astype(np.float32)
    boxes = rng.uniform(-2, 26, (5, 4)).astype(np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    boxes[1] = [3.0, 4.0, 10.0, 11.0]
    got = tm.crop_mask(*_t(masks, boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.crop_mask(
        *_j(masks, boxes))))


@pytest.mark.parametrize("upsample", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_process_mask(upsample, seed):
    protos, coefs, boxes = _inputs(seed)
    ref = np.asarray(jm.process_mask(*_j(protos, coefs, boxes), (128, 128),
                                     upsample=upsample))
    got = tm.process_mask(*_t(protos, coefs, boxes), (128, 128),
                          upsample=upsample).numpy()
    assert got.shape == ref.shape == ((6, 128, 128) if upsample
                                      else (6, 32, 32))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_process_mask_rectangular_input():
    protos, coefs, boxes = _inputs(2, hp=24, wp=32)
    ref = np.asarray(jm.process_mask(*_j(protos, coefs, boxes), (96, 128),
                                     upsample=True))
    got = tm.process_mask(*_t(protos, coefs, boxes), (96, 128),
                          upsample=True).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_process_mask_upsample():
    protos, coefs, boxes = _inputs(4)
    ref = np.asarray(jm.process_mask_upsample(*_j(protos, coefs, boxes),
                                              (128, 128)))
    got = tm.process_mask_upsample(*_t(protos, coefs, boxes),
                                   (128, 128)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("dst_hw", [(96, 128), (75, 100), (20, 15)],
                         ids=["up", "up_odd_pad", "down"])
def test_process_mask_native(dst_hw):
    """Up to the original image, and down (20 x 15 from the 32 x 32
    prototypes: jax antialiases, the port asks F.interpolate to)."""
    protos, coefs, boxes = _inputs(5)
    boxes = boxes * (dst_hw[1] / 128)
    ref = np.asarray(jm.process_mask_native(*_j(protos, coefs, boxes),
                                            dst_hw))
    got = tm.process_mask_native(*_t(protos, coefs, boxes), dst_hw).numpy()
    assert got.shape == ref.shape == (6, *dst_hw)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_no_detections():
    protos, coefs, boxes = _inputs(6)
    got = tm.process_mask(*_t(protos, coefs[:0], boxes[:0]), (128, 128),
                          upsample=True)
    assert tuple(got.shape) == (0, 128, 128)


def test_product_ignores_autocast():
    """Under bf16 autocast the prototype product stays f32."""
    protos, coefs, boxes = _inputs(7)
    ref = tm.process_mask(*_t(protos, coefs, boxes), (128, 128))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tm.process_mask(*_t(protos, coefs, boxes), (128, 128))
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,im0", [((128, 128), (96, 128, 3)),
                                       ((128, 128), (128, 100, 3)),
                                       ((64, 64), (64, 64, 3))])
def test_scale_image_equal(shape, im0):
    rng = np.random.default_rng(8)
    m = rng.random((*shape, 3)).astype(np.float32)
    np.testing.assert_array_equal(tm.scale_image(m, im0),
                                  jm.scale_image(m, im0))
    ratio_pad = (1.0, (0.0, 16.0))
    np.testing.assert_array_equal(tm.scale_image(m, im0, ratio_pad),
                                  jm.scale_image(m, im0, ratio_pad))


@pytest.mark.parametrize("strategy", ["largest", "concat"])
def test_masks2segments_equal(strategy):
    m = np.zeros((3, 40, 40), bool)
    m[0, 5:20, 5:30] = True
    m[0, 25:35, 25:35] = True             # a second, smaller blob
    m[1, 10:12, 3:39] = True
    got = tm.masks2segments(m, strategy)
    ref = jm.masks2segments(m, strategy)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (0, 2)
