"""tpucv_torch's ``ops/coords.py`` against tpucv's, on the CPU: every
function on the same numpy inputs (f32 boxes and points from a seed, some
outside the image so the clips bite), within 1e-6 (absolute, on values of
a few hundred pixels: the same f32 operations in the same order give the
same bits; the bound is for the rounding of a Python scalar pad or gain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.ops import coords as jc
from tpucv_torch.ops import coords as tc

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=0)


def _boxes(seed=0, n=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-40, 700, (n, 2))
    wh = rng.uniform(1, 300, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _both(fn_name, x, *args, **kw):
    ref = np.asarray(getattr(jc, fn_name)(jnp.asarray(x), *args, **kw))
    got = getattr(tc, fn_name)(torch.from_numpy(x), *args, **kw).numpy()
    return got, ref


@pytest.mark.parametrize("fn,args,kw", [
    ("clip_boxes", ((480, 640),), {}),
    ("xywhn2xyxy", (), {"w": 640, "h": 480, "padw": 3, "padh": 7}),
    ("xyxy2xywhn", (), {"w": 640, "h": 480}),
    ("xyxy2xywhn", (), {"w": 640, "h": 480, "clip": True, "eps": 1e-3}),
    ("xywh2ltwh", (), {}),
    ("xyxy2ltwh", (), {}),
    ("ltwh2xywh", (), {}),
    ("ltwh2xyxy", (), {}),
])
def test_box_functions(fn, args, kw):
    x = _boxes(1)
    if fn == "xywhn2xyxy":
        x = x / 700.0
    got, ref = _both(fn, x, *args, **kw)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("fn,args", [
    ("clip_coords", ((480, 640),)),
    ("xyn2xy", (640, 480, 5, 9)),
])
def test_point_functions(fn, args):
    x = _boxes(2)[:, :2].reshape(8, 8, 2)
    if fn == "xyn2xy":
        x = x / 700.0
    got, ref = _both(fn, x, *args)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("ratio_pad", [None, ((0.5, 0.5), (16.0, 40.0))])
@pytest.mark.parametrize("img0", [(480, 640), (900, 500, 3)])
def test_scale_boxes(img0, ratio_pad):
    x = _boxes(3)
    ref = np.asarray(jc.scale_boxes((640, 640), jnp.asarray(x), img0,
                                    ratio_pad))
    got = tc.scale_boxes((640, 640), torch.from_numpy(x), img0,
                         ratio_pad).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("channels", [2, 3])
def test_scale_coords(channels, normalize):
    rng = np.random.default_rng(4)
    k = rng.uniform(-20, 660, (5, 17, channels)).astype(np.float32)
    if channels == 3:
        k[..., 2] = rng.uniform(0, 1, (5, 17))       # visibility passes
    ref = np.asarray(jc.scale_coords((640, 640), jnp.asarray(k), (480, 640),
                                     normalize=normalize))
    got = tc.scale_coords((640, 640), torch.from_numpy(k), (480, 640),
                          normalize=normalize).numpy()
    assert got.shape == ref.shape == k.shape
    np.testing.assert_allclose(got, ref, **TOL)


def _polygons(seed=5):
    rng = np.random.default_rng(seed)
    out = [rng.uniform(-50, 700, (rng.integers(3, 12), 2)).astype(np.float32)
           for _ in range(6)]
    out.append(np.array([[-5.0, -5.0], [-1.0, -2.0], [-3.0, -1.0]],
                        np.float32))                  # wholly outside
    return out


def test_segment2box():
    for s in _polygons():
        np.testing.assert_array_equal(tc.segment2box(s, 640, 480),
                                      jc.segment2box(s, 640, 480))


def test_segments2boxes():
    segs = _polygons() + [np.zeros((0, 2), np.float32)]
    got, ref = tc.segments2boxes(segs), jc.segments2boxes(segs)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


def test_resample_segments_and_make_divisible():
    segs = _polygons()
    for g, r in zip(tc.resample_segments(segs, 50),
                    jc.resample_segments(segs, 50)):
        np.testing.assert_allclose(g, r, **TOL)
    for x, d in [(33, 8), (32, 8), (1.5, 1), (100, 32)]:
        assert tc.make_divisible(x, d) == jc.make_divisible(x, d)
