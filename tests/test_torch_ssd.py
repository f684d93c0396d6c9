"""SSD: tpucv_torch against tpucv, module by module, in f32 on the CPU, at
the shipped widths (SSD's geometry is fixed at 300 and 512). Both packages
get the same weights: the port's seeded init with every BatchNorm and
every conv bias drawn from a numpy seed, carried into flax by tpucv's
``import_ssd`` (which also skips tpucv's ``jax.jit(model.init)``). Held:

- the config's tables, loss and decode settings equal to tpucv's;
- the priors bit-equal at 300 (8,732) and 512 (24,564);
- ``L2Norm`` (f32 and bf16), the ceil-mode pool (75 -> 38) and pool5 at
  small shapes: L2Norm within 1e-6 relative (f32; bf16 equal), pools
  exact;
- the forward at 300 and 512 (one B=1 forward each, shared), loc and conf
  within 1e-4 of their largest value; the parameter counts 26,293,934
  and 27,197,124;
- the weights across: the port's ``state_dict`` through tpucv's
  ``import_ssd`` and back through ``from_flax_variables``, exact and
  strict; the reference's layer slots (conv4_3's ReLU at 32, conv6 at 44,
  conv7 at 46);
- ``encode_boxes``: the centre offsets bit-equal (XLA's reciprocal
  products), the log-size offsets within 1e-6 relative (XLA's own log
  parts from PyTorch's by an ulp); ``decode_boxes`` within 1e-6;
- ``assign_ssd_targets`` against tpucv's jitted batch: cls and pos
  bit-equal, loc within 1e-6 (relative to values above 1), over seeds,
  two GTs sharing a best prior (the later GT wins, as XLA's scatter
  leaves it), an empty image, padded rows with boxes, and a GT whose two
  best priors tie exactly (the lower index wins). tpucv's assignment is
  jitted with the priors a constant, as its loss captures them; its IoU
  then rounds as plain f32 arithmetic, the port's (with the priors a
  traced argument XLA:CPU fuses a multiply-add into the union, and
  near-ties can part);
- ``multibox_loss`` (jitted in tpucv, the targets assigned inside): total
  and terms within 1e-5 relative, num_pos equal, over seeds, a batch with
  no positives (the 100-negative fallback) and conf maps whose rows repeat
  a few patterns, so that the hard-negative cutoff falls inside a tie
  (stable order); the gradients of loc and conf within 1e-4 of the
  largest element. The random cases draw the background logit from a
  spread of distinct values: XLA's exp and PyTorch's part by an ulp, and
  two negatives whose non-background mass ties within an ulp at the
  cutoff would be taken in either order;
- the multilabel NMS: keep sets, classes and scores identical to tpucv's
  over random cases with tied scores, and tpucv's ``nms_fixpoint`` keep
  sets on the SSD offset cases of ``ops/nms_cases.py`` (K = 1,024 at
  B = 1, 8 and 32; offsets up to 19 x 7680 px) through the port's
  dispatch (``nms_keep``'s plain version on the CPU);
- ``decode_ssd`` on sharpened maps (every score 0 or 1, ties by flat
  index) at conf 0.7 and 0.01, and on random maps: valid and classes
  equal, scores within 1e-5, boxes within 1e-4 px.

``test_torch_ssd_slice.py`` holds the algorithm, the trainer, int8 and the
CLIs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_yolov7 import randomize_bn
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt.importer import import_ssd
from tpucv.decode.ssd import decode_ssd as j_decode
from tpucv.losses.multibox import multibox_loss as j_loss
from tpucv.losses.multibox import smooth_l1 as j_smooth_l1
from tpucv.models.ssd import SSD as JSSD
from tpucv.models.ssd import L2Normalize as JL2Norm
from tpucv.models.ssd import max_pool as j_max_pool
from tpucv.ops.anchors import generate_ssd_anchors as j_priors
from tpucv.ops.nms import batched_non_max_suppression_multilabel as j_mlnms
from tpucv.ops.nms import nms_fixpoint as j_fixpoint
from tpucv.targets.ssd import assign_ssd_targets_batch as j_assign
from tpucv.targets.ssd import decode_boxes as j_decode_boxes
from tpucv.targets.ssd import encode_boxes as j_encode
from tpucv_torch.builder import export_from_registry
from tpucv_torch.check import MODELS
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.configs.model_cfgs import ssd_tables
from tpucv_torch.decode.ssd import decode_ssd
from tpucv_torch.losses.multibox import multibox_loss, smooth_l1
from tpucv_torch.models.ssd import SSD, L2Norm, vgg16_bn_layers
from tpucv_torch.nn.blocks import HookedConv2d
from tpucv_torch.ops.anchors import generate_ssd_anchors
from tpucv_torch.ops.boxes import pairwise_iou
from tpucv_torch.ops.nms import (batched_non_max_suppression_multilabel,
                                 dispatch_batched_nms)
from tpucv_torch.ops.nms_cases import ssd_cases
from tpucv_torch.targets.ssd import (assign_ssd_targets, decode_boxes,
                                     encode_boxes)

torch.set_num_threads(1)
FWD_REL = 1e-4
LOC_TOL = 1e-6
LOSS_REL = 1e-5
GRAD_TOL = 1e-4
DEC_TOL, BOX_PX_TOL = 1e-5, 1e-4
NC = 21                                   # 20 VOC classes + background
PARAMS = {300: 26_293_934, 512: 27_197_124}
GAIN = 50.0                               # a sharpened logit: softmax 1 or 0


# ----------------------------------------------------------------- weights
def port_model(size, seed=0):
    """The port's seeded init, BatchNorm and conv biases drawn from a numpy
    seed (the init leaves them at the identity and 0)."""
    model = SSD(NC, size).reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    randomize_bn(model, rng)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.from_numpy(
                    rng.normal(0, 0.05, m.bias.shape).astype(np.float32)))
    return model.eval()


def numpy_sd(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def pair(size):
    """(tpucv module, tpucv variables, port model) with the same weights."""
    model = port_model(size)
    return JSSD(NC, size), import_ssd(numpy_sd(model)), model


def priors(size):
    t = ssd_tables(size)
    return generate_ssd_anchors(size, t["feature_shapes"], t["anchor_sizes"],
                                t["aspect_ratios"])


@functools.lru_cache(maxsize=None)
def forwards(size):
    """One B=1 forward through each package."""
    jm, variables, model = pair(size)
    x = np.random.default_rng(size).random((1, size, size, 3), np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("size", [300, 512])
def test_config_and_tables_equal_tpucv(size):
    jcfg, _, _ = tpucv_export("ssd")
    tcfg, _, _ = export_from_registry("ssd")
    for c in (jcfg, tcfg):
        c.arch.input_size = c.dataset.input_size = size
    assert tcfg.arch.tables == jcfg.arch.tables
    assert tcfg.num_classes == jcfg.num_classes == NC
    assert tcfg.arch.variances == jcfg.arch.variances == (0.1, 0.2)
    for sec in ("loss", "decode", "optimizer", "dataset", "train"):
        assert vars(getattr(tcfg, sec)) == vars(getattr(jcfg, sec)), sec
    assert tcfg.loss.alpha == 0.5
    assert (tcfg.decode.conf_threshold, tcfg.decode.iou_threshold,
            tcfg.decode.max_det, tcfg.decode.pre_nms_topk) == (0.7, 0.5, 100,
                                                               1024)
    assert "ssd" in MODELS


@pytest.mark.parametrize("size,n", [(300, 8732), (512, 24564)])
def test_priors_bit_equal(size, n):
    t = ssd_tables(size)
    ref = np.asarray(j_priors(size, t["feature_shapes"], t["anchor_sizes"],
                              t["aspect_ratios"]))
    got = priors(size)
    assert got.shape == ref.shape == (n, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2norm_equal(dtype):
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(0, 3, (2, 5, 7, 16))).astype(np.float32)
    x[0, 0, 0] = 0.0                             # the 1e-10 guards a zero
    scale = rng.uniform(5, 30, 16).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = JL2Norm().apply({"params": {"scale": jnp.asarray(scale)}}, jx)
    m = L2Norm(16)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch,
                                                               dtype))
        got = m(tx).permute(0, 2, 3, 1).float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == ref.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert np.all(got[0, 0, 0] == 0)


def _pool_in(h, w, seed=2):
    return np.random.default_rng(seed).normal(0, 1, (2, h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("h,w", [(75, 75), (38, 38), (19, 19), (9, 9)])
def test_ceil_pool_and_pool5_equal(h, w):
    """The block-3 pool (ceil mode: 75 -> 38), the 2x2 pools and pool5
    (3x3, stride 1, pad 1) in their slots of the layer list."""
    layers = vgg16_bn_layers()
    ceil, plain, pool5 = layers[23], layers[6], layers[43]
    x = _pool_in(h, w)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    for mod, kw in ((ceil, dict(ceil=True)), (plain, {}),
                    (pool5, dict(k=3, s=1, pad_same=True))):
        ref = np.asarray(j_max_pool(jnp.asarray(x), **kw))
        got = mod(tx).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, ref)
    assert ceil(torch.zeros(1, 1, 75, 75)).shape[-1] == 38


# ----------------------------------------------------------------- network
@pytest.mark.parametrize("size", [300, 512])
def test_param_count(size):
    _, variables, model = pair(size)
    assert sum(p.numel() for p in model.parameters()) == PARAMS[size]
    assert sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"])) == PARAMS[size]


@pytest.mark.parametrize("size", [300, 512])
def test_forward_equal(size):
    ref, got = forwards(size)
    A = priors(size).shape[0]
    assert [g.shape for g in got] == [(1, A, 4), (1, A, NC)]
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert np.abs(r - g).max() <= FWD_REL * np.abs(r).max()


@pytest.mark.parametrize("size", [300, 512])
def test_weights_round_trip_through_import_ssd(size):
    """The port's ``state_dict`` -> tpucv's ``import_ssd`` (whose tree ran
    the forward above) -> ``from_flax_variables``: every tensor back
    exactly, and it loads with ``strict=True``."""
    _, variables, model = pair(size)
    sd = from_flax_variables(variables)
    assert sorted(sd) == sorted(model.state_dict())
    fresh = SSD(NC, size)
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_vgg_refuses_a_batchnorm_without_its_conv(monkeypatch):
    from tpucv_torch.models import ssd as ssd_mod

    built = ssd_mod.vgg16_bn_layers

    def with_stray_bn():
        layers = built()
        layers.insert(3, torch.nn.BatchNorm2d(64))    # after conv1_1's ReLU
        return layers

    monkeypatch.setattr(ssd_mod, "vgg16_bn_layers", with_stray_bn)
    with pytest.raises(TypeError, match="layers.3"):
        ssd_mod.VGG16BN()


def test_reference_layer_slots():
    model = pair(300)[2]
    layers = model.backbone.layers
    assert len(layers) == 48
    convs = [i for i, m in enumerate(layers) if isinstance(m, HookedConv2d)]
    assert convs[-2:] == [44, 46]
    assert isinstance(layers[32], torch.nn.ReLU)
    assert isinstance(layers[31], torch.nn.BatchNorm2d)
    assert layers[30].bn is layers[31] and layers[44].bn is None
    assert tuple(layers[44].dilation) == (6, 6)
    bns = {i for i, m in enumerate(layers)
           if isinstance(m, torch.nn.BatchNorm2d)}
    assert model.backbone.paired == bns and len(bns) == 13
    assert all(layers[i - 1].bn is layers[i] for i in bns)
    keys = model.state_dict()
    assert {"l2_norm.weight", "extras.conv8.weight", "locs.5.weight",
            "confs.0.bias", "backbone.layers.46.bias"} <= set(keys)


# -------------------------------------------------------------- box coding
def _boxes(rng, shape, lo=0.02, hi=0.6):
    cxy = rng.uniform(0.0, 1.0, (*shape, 2))
    wh = rng.uniform(lo, hi, (*shape, 2))
    return np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1),
                   0, 1).astype(np.float32)


def test_encode_and_decode_boxes_equal():
    rng = np.random.default_rng(3)
    pri = priors(300)
    gt = _boxes(rng, (pri.shape[0],))
    ref = np.asarray(jax.jit(j_encode)(jnp.asarray(gt), jnp.asarray(pri)))
    got = encode_boxes(torch.from_numpy(gt), torch.from_numpy(pri)).numpy()
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 2:], ref[:, 2:], rtol=LOC_TOL,
                               atol=LOC_TOL)
    loc = rng.normal(0, 1, pri.shape).astype(np.float32)
    ref = np.asarray(jax.jit(j_decode_boxes)(jnp.asarray(loc),
                                             jnp.asarray(pri)))
    got = decode_boxes(torch.from_numpy(loc), torch.from_numpy(pri)).numpy()
    np.testing.assert_allclose(got, ref, rtol=LOC_TOL, atol=LOC_TOL)


# ----------------------------------------------------------------- targets
M = 12


def _gt(seed, b=3):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, (b, M))
    labels = rng.integers(0, 20, (b, M)).astype(np.int32)
    mask = rng.random((b, M)) < 0.7
    mask[:, 0] = True
    return boxes, labels, mask


@functools.lru_cache(maxsize=None)
def _j_assign():
    """tpucv's batched assignment, jitted with the priors a constant of the
    program, as tpucv's ``Ssd.build_loss`` captures them: XLA then folds
    the priors' areas, and the IoU rounds as plain f32 arithmetic (with
    the priors an argument, XLA:CPU fuses the prior area into the sum of
    the areas as a multiply-add)."""
    pri = jnp.asarray(priors(300))
    return jax.jit(lambda b, l, m: j_assign(b, l, m, pri, 0.5, (0.1, 0.2)))


def _targets_both(boxes, labels, mask):
    pri = priors(300)
    ref = _j_assign()(jnp.asarray(boxes), jnp.asarray(labels),
                      jnp.asarray(mask))
    got = assign_ssd_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                             torch.from_numpy(mask), torch.from_numpy(pri))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_targets_equal(boxes, labels, mask):
    (rl, rc, rp), (gl, gc, gp) = _targets_both(boxes, labels, mask)
    assert gc.dtype == np.int32 and gp.dtype == np.bool_
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gl, rl, rtol=LOC_TOL, atol=LOC_TOL)
    return gl, gc, gp


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_targets_equal_over_seeds(seed):
    _, _, pos = _assert_targets_equal(*_gt(seed))
    assert pos.sum(1).min() > 0


def test_targets_two_gts_share_a_best_prior():
    """GT 1 and GT 3 are one box with different labels, so every prior's
    IoU ties between them: a prior matched by threshold takes the lower GT
    (argmax's first index), while their shared best prior, forced by both,
    takes the later one (tpucv's duplicate-index scatter keeps the last
    write)."""
    boxes, labels, mask = _gt(4)
    boxes[:, 3] = boxes[:, 1]
    labels[:, 1], labels[:, 3] = 2, 9
    mask[:, [1, 3]] = True
    _, cls, pos = _assert_targets_equal(boxes, labels, mask)
    iou = pairwise_iou(torch.from_numpy(boxes),
                       torch.from_numpy(priors(300))).numpy()
    for b in range(boxes.shape[0]):
        best = iou[b, 1].argmax()
        assert pos[b, best] and cls[b, best] == 9 + 1
        own = (iou[b, 1] >= 0.5) & (iou[b, 1] >= iou[b].max(0))
        own[best] = False
        assert own.any() and np.all(cls[b, own] == 2 + 1)


def test_targets_with_an_empty_image():
    boxes, labels, mask = _gt(5)
    mask[1] = False
    _, cls, pos = _assert_targets_equal(boxes, labels, mask)
    assert not pos[1].any() and not cls[1].any() and pos[0].any()


def test_targets_padded_rows_claim_nothing():
    """Padded rows keep boxes (one covers the first prior best): they are
    dropped, whatever they hold."""
    boxes, labels, mask = _gt(6)
    pri = priors(300)
    boxes[:, -1] = pri[0]
    boxes[:, -2] = [0.0, 0.0, 1.0, 1.0]
    mask[:, -2:] = False
    _, cls, pos = _assert_targets_equal(boxes, labels, mask)
    ref_boxes = boxes.copy()
    ref_boxes[:, -2:] = 0.0
    _, cls0, pos0 = _assert_targets_equal(ref_boxes, labels, mask)
    np.testing.assert_array_equal(pos, pos0)
    np.testing.assert_array_equal(cls, cls0)


def test_targets_exact_iou_tie_takes_the_lower_prior():
    """A GT spanning two neighbouring min-size priors of one row whose
    widths are bit-equal: it holds both whole, so their IoUs tie exactly,
    and the GT's best prior is the lower index in both engines."""
    pri = priors(300)
    row = [(10 * 38 + c) * 4 for c in range(5, 30)]     # level 0, row 10
    w = pri[row, 2] - pri[row, 0]
    c = next(k for k in range(len(row) - 1) if w[k] == w[k + 1])
    lo, hi = row[c], row[c + 1]
    gt = np.array([pri[lo, 0], pri[lo, 1], pri[hi, 2], pri[lo, 3]],
                  np.float32)
    boxes, labels, mask = _gt(7)
    boxes[:, 0] = gt
    iou = pairwise_iou(torch.from_numpy(gt[None]), torch.from_numpy(pri))[0]
    assert iou[lo] == iou[hi] == iou.max() and int(iou.argmax()) == lo
    _assert_targets_equal(boxes, labels, mask)


# -------------------------------------------------------------------- loss
def _conf_maps(rng, b, A, spread=True):
    """Random logits whose background logit is a spread of distinct values
    (a permutation of a ramp over 1..7: background probabilities 0.1-0.98),
    so the non-background masses that rank the negatives lie apart by
    hundreds of ulps."""
    conf = rng.normal(0, 0.5, (b, A, NC)).astype(np.float32)
    if spread:
        ramp = np.linspace(1.0, 7.0, b * A, dtype=np.float32)
        conf[..., 0] = rng.permutation(ramp).reshape(b, A)
    return conf


def _loss_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    A = priors(300).shape[0]
    loc = rng.normal(0, 1, (b, A, 4)).astype(np.float32)
    boxes, labels, mask = _gt(seed + 40, b)
    return loc, _conf_maps(rng, b, A), boxes, labels, mask


@functools.lru_cache(maxsize=None)
def _j_loss_fns():
    pri = jnp.asarray(priors(300))

    def f(loc, conf, boxes, labels, mask):
        t = j_assign(boxes, labels, mask, pri, 0.5, (0.1, 0.2))
        return j_loss(loc, conf, *t, neg_pos_ratio=3, alpha=0.5)

    return jax.jit(f), jax.jit(jax.grad(lambda *a: f(*a)[0], argnums=(0, 1)))


def _port_loss(loc, conf, boxes, labels, mask):
    t = assign_ssd_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                           torch.from_numpy(mask),
                           torch.from_numpy(priors(300)))
    return multibox_loss(loc, conf, *t, neg_pos_ratio=3, alpha=0.5)


def _assert_loss_equal(loc, conf, boxes, labels, mask):
    jf, _ = _j_loss_fns()
    rt, rp = jf(loc, conf, boxes, labels, mask)
    gt, gp = _port_loss(torch.from_numpy(loc), torch.from_numpy(conf), boxes,
                        labels, mask)
    assert sorted(gp) == sorted(rp)
    assert float(gp["num_pos"]) == float(rp["num_pos"])
    assert float(gt) == pytest.approx(float(rt), rel=LOSS_REL)
    for k in ("loc_loss", "conf_loss"):
        assert float(gp[k]) == pytest.approx(float(rp[k]), rel=LOSS_REL,
                                             abs=1e-12), k
    return {k: float(v) for k, v in gp.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_loss_equal_over_seeds(seed):
    parts = _assert_loss_equal(*_loss_inputs(seed))
    assert parts["num_pos"] > 0 and parts["loc_loss"] > 0


def test_loss_equal_with_no_positives():
    """No valid GT in the batch: no image has a negative budget, so the
    batch takes the 100 hardest negatives, normalised by B."""
    loc, conf, boxes, labels, mask = _loss_inputs(5)
    parts = _assert_loss_equal(loc, conf, boxes, labels,
                               np.zeros_like(mask))
    assert parts["num_pos"] == 0 and parts["loc_loss"] == 0


def test_loss_equal_when_negatives_tie_at_the_cutoff():
    """Every prior's conf row is one of four patterns: the negatives' scores
    tie in four large groups and the budget ends inside one, so the stable
    order (the lowest flat index first) picks the negatives taken."""
    loc, _, boxes, labels, mask = _loss_inputs(6)
    rng = np.random.default_rng(6)
    pats = rng.normal(0, 2, (4, NC)).astype(np.float32)
    conf = pats[rng.integers(0, 4, loc.shape[:2])]
    _assert_loss_equal(loc, conf, boxes, labels, mask)


@pytest.mark.parametrize("seed", [7, 8])
def test_loss_gradients_equal(seed):
    loc, conf, boxes, labels, mask = _loss_inputs(seed)
    _, jg = _j_loss_fns()
    ref = jg(loc, conf, boxes, labels, mask)
    tl = torch.from_numpy(loc).requires_grad_()
    tc = torch.from_numpy(conf).requires_grad_()
    total, _ = _port_loss(tl, tc, boxes, labels, mask)
    total.backward()
    for r, t in zip(ref, (tl, tc)):
        r = np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0
        assert np.abs(t.grad.numpy() - r).max() <= GRAD_TOL * scale


def test_smooth_l1_equal():
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    np.testing.assert_array_equal(smooth_l1(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_smooth_l1(jnp.asarray(x))))


# ---------------------------------------------------------------------- NMS
def _ml_case(seed, b=2, A=500, nc=20):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 300, (b, A, 2))
    wh = rng.uniform(8, 120, (b, A, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0,
                    300).astype(np.float32)
    scores = (rng.integers(0, 9, (b, A, nc)) / 8.0).astype(np.float32)
    scores[:, 10:20] = scores[:, :10]               # tied anchors
    return boxes, scores


@pytest.mark.parametrize("seed,conf,iou,topk", [
    (0, 0.3, 0.5, 1024), (1, 0.01, 0.45, 1024), (2, 0.7, 0.5, 512),
    (3, 0.5, 0.3, 1024)])
def test_multilabel_nms_equal(seed, conf, iou, topk):
    boxes, scores = _ml_case(seed)
    ref = [np.asarray(r) for r in jax.jit(
        lambda b, s: j_mlnms(b, s, conf, iou, 100, topk))(
        jnp.asarray(boxes), jnp.asarray(scores))]
    got = [g.numpy() for g in batched_non_max_suppression_multilabel(
        torch.from_numpy(boxes), torch.from_numpy(scores), conf, iou, 100,
        topk)]
    assert got[3].sum() > 10
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", list(ssd_cases()))
def test_ssd_offset_cases_keep_sets_equal_nms_fixpoint(name):
    """SSD's presorted class-offset candidates (K = 1,024, B = 1, 8, 32)
    through the port's dispatch (the kernel's plain version here) against
    tpucv's ``nms_fixpoint``, the engine of its multilabel NMS."""
    (boxes, scores), thr = ssd_cases()[name]
    ref = jax.jit(jax.vmap(lambda b, s: j_fixpoint(b, s, thr, 100)))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got = dispatch_batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores), thr, 100)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1].sum() > 0


# ------------------------------------------------------------------- decode
def _raw(seed, size=300, b=2, sharpen=False):
    rng = np.random.default_rng(seed)
    A = priors(size).shape[0]
    loc = rng.normal(0, 1, (b, A, 4)).astype(np.float32)
    conf = rng.normal(0, 2, (b, A, NC)).astype(np.float32)
    if sharpen:
        # one class a prior (the background included) at GAIN, the rest 0:
        # softmax gives exactly 1 and 0, and every score ties
        conf = np.zeros_like(conf)
        win = rng.integers(0, NC, (b, A))
        np.put_along_axis(conf, win[..., None], GAIN, -1)
    return loc, conf


def _decode_both(loc, conf, conf_thr, size=300):
    pri = priors(size)
    kw = dict(conf_threshold=conf_thr, iou_threshold=0.5, max_det=100,
              pre_nms_topk=1024)
    ref = jax.jit(functools.partial(j_decode, input_size=size, **kw))(
        jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(pri))
    got = decode_ssd(torch.from_numpy(loc), torch.from_numpy(conf),
                     torch.from_numpy(pri), size, **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_same_detections(ref, got):
    rb, rs, rc, rv = ref
    gb, gs, gc, gv = got
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gc[gv], rc[rv])
    np.testing.assert_allclose(gs, rs, rtol=0, atol=DEC_TOL)
    np.testing.assert_allclose(gb, rb, rtol=1e-6, atol=BOX_PX_TOL)


@pytest.mark.parametrize("conf", [0.7, 0.01])
def test_decode_equal_on_sharpened_maps(conf):
    ref, got = _decode_both(*_raw(10, sharpen=True), conf)
    assert got[3].sum() > 50 and np.all(got[1][got[3]] == 1.0)
    _assert_same_detections(ref, got)


@pytest.mark.parametrize("seed,conf", [(1, 0.01), (2, 0.3)])
def test_decode_equal_on_random_maps(seed, conf):
    ref, got = _decode_both(*_raw(seed), conf)
    assert got[3].sum() > 0
    _assert_same_detections(ref, got)
