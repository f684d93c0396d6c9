"""tpucv_torch's loss extras (``losses/extras.py``) against tpucv's, on the
CPU in f32, within 1e-5 relative: the varifocal loss, YOLOX's IoU loss in
its iou and giou modes (xywh and xyxy boxes) and MultiBox v1, whose
per-image hard-negative rank is two stable argsorts: the tests put ties
(equal CE rows) across the cut of each image's negative budget, so the
anchor index decides which negatives count, as in tpucv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.losses import extras as je
from tpucv_torch.losses import extras as te

torch.set_num_threads(1)
REL = 1e-5


def _rel(got, ref):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= REL * max(abs(ref), 1e-12), (got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_varifocal_loss(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (2, 300, 8)).astype(np.float32)
    label = (rng.random((2, 300, 8)) < 0.1).astype(np.float32)
    gt = (rng.random((2, 300, 8)) * label).astype(np.float32)
    ref = je.varifocal_loss(jnp.asarray(logits), jnp.asarray(gt),
                            jnp.asarray(label))
    got = te.varifocal_loss(torch.from_numpy(logits), torch.from_numpy(gt),
                            torch.from_numpy(label))
    _rel(got, ref)


def _box_pairs(seed, xywh):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 200, (500, 2))
    wa = rng.uniform(2, 80, (500, 2))
    b = a + rng.normal(0, 15, (500, 2))
    wb = wa * rng.uniform(0.5, 1.5, (500, 2))
    if xywh:
        return (np.concatenate([a, wa], -1).astype(np.float32),
                np.concatenate([b, wb], -1).astype(np.float32))
    return (np.concatenate([a, a + wa], -1).astype(np.float32),
            np.concatenate([b, b + wb], -1).astype(np.float32))


@pytest.mark.parametrize("xywh", [True, False])
@pytest.mark.parametrize("mode", ["iou", "giou"])
def test_iou_loss(mode, xywh):
    p, t = _box_pairs(3, xywh)
    ref = np.asarray(je.iou_loss(jnp.asarray(p), jnp.asarray(t), mode, xywh))
    got = te.iou_loss(torch.from_numpy(p), torch.from_numpy(t), mode,
                      xywh).numpy()
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * 1e-3)
    _rel(got.sum(), ref.sum())


def _multibox_inputs(seed, B=3, A=200, nc=6):
    rng = np.random.default_rng(seed)
    loc_p = rng.normal(0, 1, (B, A, 4)).astype(np.float32)
    loc_t = rng.normal(0, 1, (B, A, 4)).astype(np.float32)
    conf = rng.normal(0, 2, (B, A, nc)).astype(np.float32)
    pos = rng.random((B, A)) < 0.05
    pos[2] = False                                   # an image without any
    cls = np.where(pos, rng.integers(1, nc, (B, A)), 0).astype(np.int32)
    # ties: blocks of equal-CE negatives (identical rows, class 0) across
    # each image's budget (3 x its positives)
    for b in range(2):
        n_neg = 3 * int(pos[b].sum())
        neg = np.flatnonzero(~pos[b])
        order = neg[np.argsort(-conf[b, neg, 1:].max(-1), kind="stable")]
        cut = order[max(n_neg - 3, 0):n_neg + 3]
        conf[b, cut] = conf[b, cut[0]]
    return loc_p, conf, loc_t, cls, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multibox_loss_v1(seed):
    args = _multibox_inputs(seed)
    ref_total, ref_parts = jax.jit(je.multibox_loss_v1)(
        *(jnp.asarray(a) for a in args))
    got_total, got_parts = te.multibox_loss_v1(
        *(torch.from_numpy(a) for a in args))
    _rel(got_total, ref_total)
    for k in ("loc_loss", "conf_loss"):
        _rel(got_parts[k], ref_parts[k])


def test_multibox_loss_v1_ties_rank_by_anchor():
    """Three negatives of equal CE (anchors 2, 3, 4) and a budget of two:
    the loss is the same whichever two count, but the gradient shows
    which: the lower anchor indices, 2 and 3, in both engines."""
    A, nc = 8, 3
    loc = np.zeros((1, A, 4), np.float32)
    conf = np.zeros((1, A, nc), np.float32)
    conf[0, 2:5, 1] = 2.0
    conf[0, 5, 1] = 1.0                              # a weaker negative
    pos = np.zeros((1, A), bool)
    pos[0, 0] = True
    cls = pos.astype(np.int32)

    def j_loss(c):
        return je.multibox_loss_v1(jnp.asarray(loc), c, jnp.asarray(loc),
                                   jnp.asarray(cls), jnp.asarray(pos),
                                   neg_pos_ratio=2)[0]

    ref_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(conf)))
    c = torch.from_numpy(conf).requires_grad_()
    total, _ = te.multibox_loss_v1(torch.from_numpy(loc), c,
                                   torch.from_numpy(loc),
                                   torch.from_numpy(cls),
                                   torch.from_numpy(pos), neg_pos_ratio=2)
    total.backward()
    _rel(total.detach(), j_loss(jnp.asarray(conf)))
    counted = np.abs(ref_grad[0]).sum(-1) > 0
    assert counted.tolist() == [True, False, True, True, False, False,
                                False, False]
    np.testing.assert_allclose(c.grad.numpy(), ref_grad, rtol=REL, atol=1e-7)


def test_keypoint_loss():
    rng = np.random.default_rng(6)
    pk = rng.uniform(0, 64, (2, 5, 17, 2)).astype(np.float32)
    gk = pk + rng.normal(0, 3, pk.shape).astype(np.float32)
    mask = (rng.random((2, 5, 17)) < 0.7).astype(np.float32)
    area = rng.uniform(10, 400, (2, 5)).astype(np.float32)
    sig = rng.uniform(0.02, 0.1, 17).astype(np.float32)
    ref = je.keypoint_loss(*(jnp.asarray(a) for a in (pk, gk, mask, area,
                                                      sig)))
    got = te.keypoint_loss(*(torch.from_numpy(a) for a in (pk, gk, mask,
                                                           area, sig)))
    _rel(got, ref)
