"""tpucv_torch YOLOv8 decode against tpucv's, on identical random raw maps.

classes and valid must be exact; boxes within 1e-3 px and scores within
1e-6 (the DFL expectation sums in a different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.decode import yolov8 as jd
from tpucv.ops import anchors as ja
from tpucv.ops import boxes as jb
from tpucv_torch.decode import yolov8 as td
from tpucv_torch.ops import anchors as ta
from tpucv_torch.ops import boxes as tb

torch.set_num_threads(1)


def _raw_maps(B=2, S=128, nc=80, seed=0, spread=2.0):
    rng = np.random.default_rng(seed)
    maps = []
    for s in (8, 16, 32):
        m = rng.normal(0, spread, (B, S // s, S // s, 64 + nc))
        m[..., 64:] -= 1.0          # about a third of anchors pass 0.25
        maps.append(m.astype(np.float32))
    return maps


def test_make_anchors():
    shapes = [(16, 20), (8, 10), (4, 5)]
    pts, st = ta.make_anchors(shapes, (8, 16, 32), device="cpu")
    rp, rs = ja.make_anchors(shapes, (8, 16, 32))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(st.numpy(), np.asarray(rs))


def test_box_conversions():
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 15, (3, 50, 4)).astype(np.float32)
    a = rng.uniform(0, 80, (50, 2)).astype(np.float32)
    for xywh in (False, True):
        np.testing.assert_array_equal(
            tb.dist2bbox(torch.from_numpy(d), torch.from_numpy(a),
                         xywh).numpy(),
            np.asarray(jb.dist2bbox(jnp.asarray(d), jnp.asarray(a), xywh)))
    box = tb.dist2bbox(torch.from_numpy(d), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(
        tb.bbox2dist(torch.from_numpy(box), torch.from_numpy(a), 16).numpy(),
        np.asarray(jb.bbox2dist(jnp.asarray(box), jnp.asarray(a), 16)))
    for fn in ("xywh2xyxy", "xyxy2xywh"):
        np.testing.assert_array_equal(
            getattr(tb, fn)(torch.from_numpy(box)).numpy(),
            np.asarray(getattr(jb, fn)(jnp.asarray(box))))


def test_raw_to_pred():
    maps = _raw_maps()
    ref = np.asarray(jd.raw_to_pred([jnp.asarray(m) for m in maps]))
    out = td.raw_to_pred([torch.from_numpy(m) for m in maps]).numpy()
    np.testing.assert_allclose(out[..., :4], ref[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], atol=1e-6, rtol=0)


@pytest.mark.parametrize("topk,conf,max_det", [(1024, 0.25, 300),
                                               (256, 0.25, 100),
                                               (4096, 0.001, 300)])
def test_decode_boxes(topk, conf, max_det):
    """K <= 1024 runs the kernel route (its plain version here), K > 1024
    the scan; letterbox-like constant regions make score ties."""
    maps = _raw_maps(seed=topk)
    maps[0][0, :4] = maps[0][0, 5]          # rows of identical anchors
    kw = dict(conf_threshold=conf, iou_threshold=0.7, max_det=max_det,
              pre_nms_topk=topk)
    ref = [np.asarray(x) for x in jd.decode_boxes(
        [jnp.asarray(m) for m in maps], **kw)]
    out = [x.numpy() for x in td.decode_boxes(
        [torch.from_numpy(m) for m in maps], **kw)]
    assert ref[3].sum() > 0
    np.testing.assert_array_equal(out[3], ref[3])              # valid
    np.testing.assert_array_equal(out[2], ref[2])              # classes
    np.testing.assert_allclose(out[0], ref[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out[1], ref[1], atol=1e-6, rtol=0)
