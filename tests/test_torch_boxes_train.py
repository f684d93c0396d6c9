"""tpucv_torch's IoU family and sigmoid BCE against tpucv's, on the same
numpy-seeded boxes, in f32 on the CPU.

Values within 1e-6 absolute (IoUs lie in [-1.5, 1]; the arctans of the
two libraries may differ by an ulp; measured ≤ 6e-8); CIoU gradients
within 1e-6 absolute for ``bbox_iou`` and 1e-5 for ``pairwise_ciou``'s
weighted sums (measured ≤ 3.8e-9 and 2.3e-8). ``alpha`` carries no
gradient on either side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.losses.common import sigmoid_bce as j_bce
from tpucv.ops import boxes as jb
from tpucv_torch.losses.common import sigmoid_bce as t_bce
from tpucv_torch.ops import boxes as tb

torch.set_num_threads(1)
TOL = 1e-6


def _xyxy(rng, shape, S=128.0):
    xy = rng.uniform(0, S * 0.7, shape + (2,))
    wh = rng.uniform(1, S * 0.4, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _xywh(rng, shape, S=128.0):
    c = rng.uniform(0, S, shape + (2,))
    wh = rng.uniform(1, S * 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_box_area_and_pairwise_iou(seed):
    rng = np.random.default_rng(seed)
    a, b = _xyxy(rng, (2, 7)), _xyxy(rng, (2, 30))
    a[0, 0] = [10, 10, 5, 5]                     # inverted: area clamps to 0
    np.testing.assert_array_equal(
        tb.box_area(torch.from_numpy(a)).numpy(),
        np.asarray(jb.box_area(jnp.asarray(a))))
    got = tb.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jb.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2, 7, 30)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert (ref > 0).any()


@pytest.mark.parametrize("xywh", [False, True])
@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_variants(kind, xywh):
    rng = np.random.default_rng(2)
    make = _xywh if xywh else _xyxy
    b1, b2 = make(rng, (3, 40)), make(rng, (3, 40))
    b2[0, :5] = b1[0, :5]                        # identical pairs: IoU 1
    flags = {kind: True} if kind != "iou" else {}
    got = tb.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh,
                      **flags).numpy()
    ref = np.asarray(jb.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh,
                                 **flags))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[0, :5], 1.0, atol=1e-6)


def test_bbox_iou_broadcasts():
    rng = np.random.default_rng(3)
    b1, b2 = _xyxy(rng, (2, 5, 1)), _xyxy(rng, (2, 1, 9))
    got = tb.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2),
                      xywh=False, ciou=True).numpy()
    ref = np.asarray(jb.bbox_iou(jnp.asarray(b1), jnp.asarray(b2),
                                 xywh=False, ciou=True))
    assert got.shape == (2, 5, 9)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [4, 5])
def test_bbox_ciou_gradient(seed):
    """d(sum CIoU)/d(both boxes), alpha detached on both sides."""
    rng = np.random.default_rng(seed)
    b1, b2 = _xyxy(rng, (64,)), _xyxy(rng, (64,))
    g1, g2 = jax.grad(lambda x, y: jb.bbox_iou(
        x, y, xywh=False, ciou=True).sum(), argnums=(0, 1))(
        jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_()
    t2 = torch.from_numpy(b2).requires_grad_()
    tb.bbox_iou(t1, t2, xywh=False, ciou=True).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(g2), atol=TOL,
                               rtol=0)


def test_pairwise_ciou_values_and_gradient():
    rng = np.random.default_rng(6)
    gt, pd = _xyxy(rng, (2, 5)), _xyxy(rng, (2, 50))
    ref, vjp = jax.vjp(jb.pairwise_ciou, jnp.asarray(gt), jnp.asarray(pd))
    w = rng.normal(size=ref.shape).astype(np.float32)
    rg, rp = vjp(jnp.asarray(w))
    tg = torch.from_numpy(gt).requires_grad_()
    tp = torch.from_numpy(pd).requires_grad_()
    got = tb.pairwise_ciou(tg, tp)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(rg), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(rp), atol=1e-5,
                               rtol=1e-5)


def test_pairwise_ciou_is_broadcast_bbox_iou():
    rng = np.random.default_rng(7)
    gt, pd = (torch.from_numpy(_xyxy(rng, (2, 4))),
              torch.from_numpy(_xyxy(rng, (2, 33))))
    pair = tb.pairwise_ciou(gt, pd)
    full = tb.bbox_iou(gt[:, :, None], pd[:, None], xywh=False, ciou=True)
    np.testing.assert_allclose(pair.numpy(), full.numpy(), atol=1e-6, rtol=0)


def test_sigmoid_bce():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 8, (4, 300)).astype(np.float32)
    y = rng.uniform(0, 1, (4, 300)).astype(np.float32)
    y[0] = 0.0
    got = t_bce(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(j_bce(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got, torch.nn.functional.binary_cross_entropy_with_logits(
            torch.from_numpy(x), torch.from_numpy(y),
            reduction="none").numpy(), rtol=1e-5, atol=1e-5)
