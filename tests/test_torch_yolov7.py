"""YOLOv7: tpucv_torch against tpucv, module by module and as a whole, in
f32 on the CPU, at full width (no width cut exists for YOLOv7) and small
inputs. Both packages get the same weights: the port's seeded init with
every BatchNorm drawn from a numpy seed, carried into flax by tpucv's
``import_yolov7`` (phi l; phi x through tpucv's own conversion helpers,
since its importer reads RepConv keys). Held:

- the forward of ``Yolo7`` l and x at 64² in eval mode, and the
  BatchNorm statistics a train-mode forward leaves: within 5e-4 (tpucv's
  golden bound). The train-mode outputs within 2x the port's own f32
  error against its float64 run: with batch statistics every one of the
  ~100 BatchNorms renormalises the rounding of the layers before it, and
  the port alone parts from float64 by 0.8-1.5e-3 on outputs of 3-5
  (measured at l, 64² and 96²; tpucv's f32 parts from the port's float64
  by 0.3-1.3e-3), so 5e-4 is out of reach of any f32 engine there. A
  fixed ceiling stands beside that bound, so that the port's own drift
  cannot widen it: 3e-3 at l and 8e-3 at x (port against tpucv at 64²,
  the worst map: 2.00e-3 at l, 6.08e-3 at x, the 2x2 P5 map, whose batch
  statistics span 8 values). The
  parameter counts 37,297,025 and 70,940,649 at nc=20;
- the weights across: ``from_flax_variables`` inverts ``import_yolov7``
  exactly and loads with ``strict=True``; a reference ``.pth`` loads
  through ``load_pretrained`` with no importer;
- ``fuse_repconv_params`` within 1e-6 of tpucv's fold on the same BN
  draws, and the fused conv within 1e-5 of ``RepConv``'s eval forward;
- ``raw_to_pred_yolo7`` within 1e-5 (px and score), ``decode_yolov7``'s
  keep sets identical (valid, classes; boxes within 1e-4 px) in both NMS
  regimes: input 128 (K = 1,008, the NMS kernel's plain version) and 256
  (K = 4,032, the scan), on sharpened maps where every score ties at 1,
  and on random maps; scores within 1e-5. ``batched_single_label_nms``
  the same on xyxy inputs with tied anchors;
- ``yolov7_loss`` (jitted in tpucv, as its train step runs it): total and
  the box / obj / cls terms within 1e-5 relative and ``num_match`` equal,
  over seeds, an empty image, GTs on the border (cells out of bounds),
  extreme aspect ratios (the ``anchor_t`` test), two identical boxes with
  different labels (the duplicate-write tie) and identical predictions
  everywhere, where every candidate's cost ties; the gradients of every
  raw map within 1e-4 of the largest element against ``jax.grad``;
- the config's gains (``loss_gains``) and decode settings equal to
  tpucv's.

``test_torch_yolov7_slice.py`` holds the algorithm, the trainer, int8 and
the CLIs.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt import importer as jimp
from tpucv.decode.yolov7 import decode_yolov7 as j_decode
from tpucv.decode.yolov7 import raw_to_pred_yolo7 as j_raw_to_pred
from tpucv.deploy import fuse_repconv_params as j_fuse
from tpucv.losses.yolov7 import yolov7_loss as j_loss
from tpucv.models.yolov7 import RepConv as JRepConv
from tpucv.models.yolov7 import Yolo7 as JYolo7
from tpucv.ops.anchors import yolo_anchor_grid as j_anchor_grid
from tpucv.ops.nms import batched_single_label_nms as j_single_label_nms
from tpucv_torch.builder import export_from_registry
from tpucv_torch.check import MODELS
from tpucv_torch.ckpt.checkpoint import load_pretrained
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.decode.yolov7 import decode_yolov7, raw_to_pred_yolo7
from tpucv_torch.deploy import fuse_repconv_params
from tpucv_torch.losses.yolov7 import _flat_geometry, yolov7_loss
from tpucv_torch.models.yolov7 import RepConv, Yolo7
from tpucv_torch.ops.anchors import yolo_anchor_grid
from tpucv_torch.ops.nms import batched_single_label_nms

torch.set_num_threads(1)
FWD_TOL = 5e-4
TRAIN_FWD_X = 2.0
TRAIN_FWD_CEIL = {"l": 3e-3, "x": 8e-3}
FUSE_TOL, FUSED_FWD_TOL = 1e-6, 1e-5
DEC_TOL, BOX_PX_TOL = 1e-5, 1e-4
LOSS_REL = 1e-5
GRAD_TOL = 1e-4
CLS_GAIN = 3000.0
SIZE = 64
PARAMS = {"l": 37_297_025, "x": 70_940_649}
ANCHORS = np.array([[[12, 16], [19, 36], [40, 28]],
                    [[36, 75], [76, 55], [72, 146]],
                    [[142, 110], [192, 243], [459, 401]]], np.float32)
STRIDES = (8, 16, 32)
NC = 20


# ----------------------------------------------------------------- weights
def randomize_bn(model: torch.nn.Module, rng) -> torch.nn.Module:
    """Every BatchNorm's affine parameters and statistics drawn from
    ``rng`` (init leaves them at the identity, which would hide an eps or a
    statistics mix-up)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0.8, 1.2, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return model


def _numpy_sd(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def flax_tree(sd, phi):
    """tpucv's variables for a reference-named state_dict: its
    ``import_yolov7`` at l; at x (a ConvBnAct before each head, which the
    importer does not read) the same steps from tpucv's helpers."""
    if phi == "l":
        return jimp.import_yolov7(sd)
    params, stats = {}, {}
    for tname, jname in jimp.YOLOV7_MODULE_MAP.items():
        if f"{tname}.conv.weight" in sd:
            jimp.convert_conv_bn(sd, tname, params, stats, (jname,))
        elif f"{tname}.cv4.conv.weight" in sd:
            jimp._convert_mcb(sd, tname, params, stats, (jname,))
        else:
            for cv in ("cv1", "cv2", "cv3"):
                jimp.convert_conv_bn(sd, f"{tname}.{cv}", params, stats,
                                     (jname, cv))
    for cv in ("cv1", "cv2", "cv3", "cv4", "cv5", "cv6", "cv7"):
        jimp.convert_conv_bn(sd, f"sppcspc.{cv}", params, stats,
                             ("sppcspc", cv))
    for i in range(3):
        jimp.convert_conv_bn(sd, f"rep_conv_{i + 1}", params, stats,
                             (f"rep{i}",))
        jimp.put(params, (f"head{i}", "kernel"),
                 jimp.t2j_conv(sd[f"yolo_head_P{i + 3}.weight"]))
        jimp.put(params, (f"head{i}", "bias"), sd[f"yolo_head_P{i + 3}.bias"])
    return {"params": params, "batch_stats": stats}


def port_model(phi, seed=0):
    model = Yolo7(nc=NC, phi=phi).reset_parameters(
        torch.Generator().manual_seed(seed))
    return randomize_bn(model, np.random.default_rng(seed)).eval()


@functools.lru_cache(maxsize=None)
def _pair(phi):
    model = port_model(phi)
    return JYolo7(nc=NC, phi=phi), flax_tree(_numpy_sd(model), phi), model


@pytest.fixture(scope="module", params=["l", "x"])
def pair(request):
    return (request.param, *_pair(request.param))


def _images(b=2, s=SIZE, seed=0):
    return np.random.default_rng(seed).random((b, s, s, 3), np.float32)


def _leaves(tree):
    return sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(tree))


# ----------------------------------------------------------------- network
def test_param_counts_equal_reference(pair):
    phi, _, variables, model = pair
    assert sum(p.numel() for p in model.parameters()) == PARAMS[phi]
    assert _leaves(variables["params"]) == PARAMS[phi]


def test_forward_eval_equal(pair):
    phi, jm, variables, model = pair
    x = _images()
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert np.abs(np.asarray(r) - g.numpy()).max() <= FWD_TOL


def test_forward_train_and_bn_stats_equal(pair):
    phi, jm, variables, model = pair
    x = _images(seed=1)
    ref, upd = jax.jit(functools.partial(jm.apply, train=True,
                                         mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    m = copy.deepcopy(model).train()
    m64 = copy.deepcopy(model).double().train()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        exact = m64(torch.from_numpy(x).double())
    for r, g, e in zip(ref, got, exact):
        own = np.abs(g.numpy() - e.numpy()).max()
        err = np.abs(np.asarray(r) - g.numpy()).max()
        assert err <= TRAIN_FWD_X * own
        assert err <= TRAIN_FWD_CEIL[phi]
    new_sd = from_flax_variables({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]})
    sd = m.state_dict()
    n = 0
    for k, v in new_sd.items():
        if "running_" in k:
            assert np.abs(v.numpy() - sd[k].numpy()).max() <= FWD_TOL, k
            n += 1
    assert n == 2 * sum(isinstance(mod, torch.nn.BatchNorm2d)
                        for mod in m.modules())


def test_weights_round_trip_through_import_yolov7(pair):
    """tpucv's tree -> the port's state_dict is exact and strict; at l,
    tpucv's ``import_yolov7`` of the port's state_dict gives tpucv's
    tree back."""
    phi, _, variables, model = pair
    sd = from_flax_variables(variables)
    assert sorted(sd) == sorted(model.state_dict())
    fresh = Yolo7(nc=NC, phi=phi)
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    back = flax_tree(_numpy_sd(fresh), phi)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(v, flat_b[path])


def test_reference_pth_loads_without_importer(tmp_path):
    _, _, model = _pair("l")
    path = str(tmp_path / "ref.pth")
    torch.save(model.state_dict(), path)
    fresh = Yolo7(nc=NC, phi="l")
    load_pretrained(fresh, path, "yolo7")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


# ------------------------------------------------------------ RepConv fold
def _rep_pair(cin, cout, seed):
    rep = randomize_bn(RepConv(cin, cout), np.random.default_rng(seed))
    with torch.no_grad():
        for p in rep.parameters():
            if p.dim() == 4:
                p.normal_(0, 0.2, generator=torch.Generator().manual_seed(seed))
    return rep.eval()


def _bn_dict(bn):
    return {"scale": bn.weight.detach().numpy(),
            "bias": bn.bias.detach().numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _stats(bn):
    return {"weight": bn.weight, "bias": bn.bias,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _port_fold(rep):
    d, o, i = rep.rbr_dense, rep.rbr_1x1, rep.rbr_identity
    with torch.no_grad():
        return fuse_repconv_params(d[0].weight, _stats(d[1]), o[0].weight,
                                   _stats(o[1]),
                                   None if i is None else _stats(i))


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)])
def test_fuse_repconv_params_equal_tpucv(cin, cout):
    rep = _rep_pair(cin, cout, 3)
    assert (rep.rbr_identity is not None) == (cin == cout)
    d, o = rep.rbr_dense, rep.rbr_1x1
    ident = None if rep.rbr_identity is None else _bn_dict(rep.rbr_identity)
    jk, jb = j_fuse(jimp.t2j_conv(d[0].weight.detach().numpy()),
                    _bn_dict(d[1]),
                    jimp.t2j_conv(o[0].weight.detach().numpy()),
                    _bn_dict(o[1]), ident)
    k, b = _port_fold(rep)
    np.testing.assert_allclose(k.numpy(), np.transpose(jk, (3, 2, 0, 1)),
                               rtol=0, atol=FUSE_TOL)
    np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=FUSE_TOL)


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)])
def test_fused_conv_equals_repconv_eval_forward(cin, cout):
    rep = _rep_pair(cin, cout, 4)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, cin, 12, 12)).astype(np.float32))
    k, b = _port_fold(rep)
    with torch.no_grad():
        ref = rep(x)
        got = torch.nn.functional.silu(
            torch.nn.functional.conv2d(x, k, b, padding=1))
    assert (got - ref).abs().max().item() <= FUSED_FWD_TOL
    # the flax RepConv on the same weights agrees with the port's too
    jr = JRepConv(cout)
    v = {"params": {"dense_conv": {"kernel": jimp.t2j_conv(
            rep.rbr_dense[0].weight.detach().numpy())},
            "one_conv": {"kernel": jimp.t2j_conv(
                rep.rbr_1x1[0].weight.detach().numpy())}},
         "batch_stats": {}}
    for name, bn in (("dense_bn", rep.rbr_dense[1]), ("one_bn", rep.rbr_1x1[1]),
                     ("id_bn", rep.rbr_identity)):
        if bn is None:
            continue
        d = _bn_dict(bn)
        v["params"][name] = {"scale": d["scale"], "bias": d["bias"]}
        v["batch_stats"][name] = {"mean": d["mean"], "var": d["var"]}
    jout = np.asarray(jr.apply(v, jnp.asarray(x.permute(0, 2, 3, 1).numpy())))
    assert np.abs(jout - ref.permute(0, 2, 3, 1).numpy()).max() <= \
        FUSED_FWD_TOL


# ------------------------------------------------------------------ decode
def _raw_maps(size, b=2, seed=0, scale=1.0, sharpen=False):
    rng = np.random.default_rng(seed)
    maps = []
    for s in STRIDES:
        m = rng.normal(0, scale, (b, size // s, size // s, 3 * (5 + NC)))
        if sharpen:
            # every objectness and class logit large: all scores tie at 1
            m = m.reshape(b, size // s, size // s, 3, 5 + NC)
            m[..., 4:] = np.abs(m[..., 4:]) * CLS_GAIN
            m = m.reshape(b, size // s, size // s, -1)
        maps.append(m.astype(np.float32))
    return maps


def test_anchor_grid_equal():
    shapes = [(8, 6), (4, 3), (2, 2)]
    ref = j_anchor_grid(ANCHORS, shapes, STRIDES)
    got = yolo_anchor_grid(ANCHORS, shapes, STRIDES, device="cpu")
    for (rg, ra), (gg, ga) in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(rg), gg.numpy())
        np.testing.assert_array_equal(np.asarray(ra), ga.numpy())


def test_raw_to_pred_equal():
    maps = _raw_maps(128, seed=1)
    rb, rs = jax.jit(functools.partial(
        j_raw_to_pred, anchors=ANCHORS, strides=STRIDES, nc=NC))(
        [jnp.asarray(m) for m in maps])
    gb, gs = raw_to_pred_yolo7([torch.from_numpy(m) for m in maps], ANCHORS,
                               STRIDES, NC)
    assert gb.shape == rb.shape == (2, 1008, 4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=DEC_TOL,
                               atol=DEC_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=0,
                               atol=DEC_TOL)


def _decode_both(maps, conf, topk):
    ref = jax.jit(functools.partial(
        j_decode, anchors=ANCHORS, strides=STRIDES, nc=NC,
        conf_threshold=conf, iou_threshold=0.3, max_det=100,
        pre_nms_topk=topk))([jnp.asarray(m) for m in maps])
    got = decode_yolov7([torch.from_numpy(m) for m in maps], ANCHORS,
                        STRIDES, NC, conf, 0.3, 100, topk)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_same_detections(ref, got, box_tol=BOX_PX_TOL):
    rb, rs, rc, rv = ref
    gb, gs, gc, gv = got
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gc[gv], rc[rv])
    np.testing.assert_allclose(gs, rs, rtol=0, atol=DEC_TOL)
    np.testing.assert_allclose(gb, rb, rtol=1e-6, atol=box_tol)


@pytest.mark.parametrize("size", [128, 256])
def test_decode_keep_sets_equal_on_tied_scores(size):
    """128: 1,008 anchors, K = 1,008 <= 1,024 (the kernel's plain
    version); 256: 4,032, the scan. Every score is 1."""
    maps = _raw_maps(size, seed=size, sharpen=True)
    ref, got = _decode_both(maps, 0.5, 4096)
    assert got[3].sum() > 10
    assert np.all(got[1][got[3]] == 1.0)
    _assert_same_detections(ref, got)


@pytest.mark.parametrize("size,conf", [(128, 0.001), (256, 0.5)])
def test_decode_equal_on_random_maps(size, conf):
    ref, got = _decode_both(_raw_maps(size, seed=7, scale=2.0), conf, 4096)
    assert got[3].sum() > 0
    _assert_same_detections(ref, got)


@pytest.mark.parametrize("seed", [11, 12])
def test_batched_single_label_nms_equal(seed):
    rng = np.random.default_rng(seed)
    A = 600
    xy = rng.uniform(0, 200, (2, A, 2))
    wh = rng.uniform(5, 60, (2, A, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.random((2, A, 5)) ** 3
    scores[:, ::7] = scores[:, :1]                       # tied anchors
    pred = np.concatenate([boxes, scores], -1).astype(np.float32)
    ref = j_single_label_nms(jnp.asarray(pred), 0.2, 0.45, 50, 512,
                             xywh=False)
    got = batched_single_label_nms(torch.from_numpy(pred), 0.2, 0.45, 50,
                                   512, xywh=False)
    _assert_same_detections([np.asarray(r) for r in ref],
                            [g.numpy() for g in got])


# -------------------------------------------------------------------- loss
M = 6


def _gt(seed, b=2):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(4, SIZE - 4, (b, M, 2))
    wh = rng.uniform(6, 40, (b, M, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    labels = rng.integers(0, NC, (b, M))
    mask = rng.random((b, M)) < 0.8
    mask[:, 0] = True
    boxes[~mask] = 0
    labels[~mask] = 0
    return boxes.astype(np.float32), labels.astype(np.int32), mask


@functools.lru_cache(maxsize=None)
def _j_loss_fn():
    def f(maps, boxes, labels, mask):
        return j_loss(maps, boxes, labels, mask, ANCHORS, STRIDES, nc=NC,
                      box_gain=0.05, obj_gain=0.01, cls_gain=0.125)
    return jax.jit(f), jax.jit(jax.grad(lambda *a: f(*a)[0]))


def _loss_both(maps, boxes, labels, mask):
    jf, _ = _j_loss_fn()
    rt, rp = jf([jnp.asarray(m) for m in maps], jnp.asarray(boxes),
                jnp.asarray(labels), jnp.asarray(mask))
    gt, gp = yolov7_loss([torch.from_numpy(m) for m in maps],
                         torch.from_numpy(boxes), torch.from_numpy(labels),
                         torch.from_numpy(mask), ANCHORS, STRIDES, nc=NC,
                         box_gain=0.05, obj_gain=0.01, cls_gain=0.125)
    return (float(rt), {k: float(v) for k, v in rp.items()},
            float(gt), {k: float(v) for k, v in gp.items()})


def _assert_loss_equal(maps, boxes, labels, mask):
    rt, rp, gt, gp = _loss_both(maps, boxes, labels, mask)
    assert sorted(gp) == sorted(rp)
    assert gp["num_match"] == rp["num_match"]
    assert gt == pytest.approx(rt, rel=LOSS_REL)
    for k in ("box_loss", "obj_loss", "cls_loss"):
        assert gp[k] == pytest.approx(rp[k], rel=LOSS_REL, abs=1e-12), k
    return gp


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_loss_equal_over_seeds(seed):
    maps = _raw_maps(SIZE, seed=seed + 20, scale=0.5)
    parts = _assert_loss_equal(maps, *_gt(seed))
    assert parts["num_match"] > 0


def test_loss_equal_with_an_empty_image():
    boxes, labels, mask = _gt(5)
    boxes[1], labels[1], mask[1] = 0, 0, False
    parts = _assert_loss_equal(_raw_maps(SIZE, seed=5, scale=0.5),
                               boxes, labels, mask)
    assert parts["num_match"] > 0
    _assert_loss_equal(_raw_maps(SIZE, seed=6, scale=0.5),
                       np.zeros_like(boxes), np.zeros_like(labels),
                       np.zeros_like(mask))


def test_loss_equal_with_gts_on_the_border():
    """Centres in the first and last cells: neighbour cells fall off the
    map and their candidates are masked."""
    boxes, labels, mask = _gt(7)
    edge = np.array([[0.5, 0.5, 9.0, 11.0], [52.0, 50.0, 63.9, 64.0],
                     [0.0, 30.0, 6.0, 40.0], [56.0, 0.0, 64.0, 7.0],
                     [1.0, 1.0, 63.0, 63.0], [30.0, 60.0, 40.0, 64.0]],
                    np.float32)
    boxes[:] = edge
    mask[:] = True
    _assert_loss_equal(_raw_maps(SIZE, seed=7, scale=0.5), boxes, labels,
                       mask)


def test_loss_equal_with_extreme_aspect_ratios():
    """Thin and flat boxes fail the anchor-ratio test (``anchor_t`` 4) at
    most anchors; one box fails it at all of them."""
    boxes, labels, mask = _gt(8)
    boxes[0] = [[10, 10, 12, 60], [5, 30, 60, 32], [20, 20, 21, 21],
                [2, 2, 62, 5], [30, 4, 33, 40], [8, 8, 40, 12]]
    mask[:] = True
    _assert_loss_equal(_raw_maps(SIZE, seed=8, scale=0.5), boxes, labels,
                       mask)


def test_loss_equal_with_duplicate_boxes_of_different_labels():
    """Two GTs with one box and different labels claim the same anchors.
    Every class probability sits under the cost's 1e-8 clip, so their
    costs tie (to an ulp, inside the 1e-6 window), while the second
    label's logit (-35 against -25) makes the class loss tell the two
    apart: tpucv's duplicate-index write keeps the later GT."""
    boxes, labels, mask = _gt(9)
    boxes[:, 1] = boxes[:, 0]
    labels[:, 0], labels[:, 1] = 2, 7
    mask[:, :2] = True
    maps = _raw_maps(SIZE, seed=9, scale=0.5)
    for m in maps:
        cls = m.reshape(*m.shape[:3], 3, 5 + NC)[..., 5:]
        cls[:] = -25.0
        cls[..., 7] = -35.0
    parts = _assert_loss_equal(maps, boxes, labels, mask)
    assert parts["num_match"] > 0


def test_loss_equal_when_every_cost_ties():
    """Identical predictions everywhere: the stable sort's slate order
    decides every GT's dynamic-k picks."""
    maps = [np.zeros_like(m) for m in _raw_maps(SIZE, seed=10)]
    _assert_loss_equal(maps, *_gt(10))


def test_loss_gradients_equal():
    maps = _raw_maps(SIZE, seed=12, scale=0.5)
    boxes, labels, mask = _gt(12)
    _, jg = _j_loss_fn()
    ref = jg([jnp.asarray(m) for m in maps], jnp.asarray(boxes),
             jnp.asarray(labels), jnp.asarray(mask))
    tm = [torch.from_numpy(m).requires_grad_() for m in maps]
    total, _ = yolov7_loss(tm, torch.from_numpy(boxes),
                           torch.from_numpy(labels), torch.from_numpy(mask),
                           ANCHORS, STRIDES, nc=NC, box_gain=0.05,
                           obj_gain=0.01, cls_gain=0.125)
    total.backward()
    for r, t in zip(ref, tm):
        r = np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0
        assert np.abs(t.grad.numpy() - r).max() <= GRAD_TOL * scale


def test_loss_geometry_cached_under_inference_mode_serves_training():
    """The anchor geometry is built once for each set of shapes; built
    first under inference mode (as an evaluation builds it), it still
    serves a training step's backward, with the gradients of a fresh
    build, exactly."""
    maps = _raw_maps(SIZE, seed=13, scale=0.5)
    boxes, labels, mask = (torch.from_numpy(a) for a in _gt(13))

    def grads():
        tm = [torch.from_numpy(m).requires_grad_() for m in maps]
        total, _ = yolov7_loss(tm, boxes, labels, mask, ANCHORS, STRIDES,
                               nc=NC)
        total.backward()
        return [t.grad for t in tm]

    _flat_geometry.cache_clear()
    fresh = grads()
    _flat_geometry.cache_clear()
    with torch.inference_mode():
        yolov7_loss([torch.from_numpy(m) for m in maps], boxes, labels,
                    mask, ANCHORS, STRIDES, nc=NC)
    hits = _flat_geometry.cache_info().hits
    again = grads()
    assert _flat_geometry.cache_info().hits == hits + 1
    for a, b in zip(fresh, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_gains_equal_tpucv():
    for size, ds in ((640, "voc"), (320, "coco")):
        jcfg, _, _ = tpucv_export("yolo7")
        tcfg, _, _ = export_from_registry("yolo7")
        for c in (jcfg, tcfg):
            c.dataset.input_size, c.dataset.name = size, ds
        assert tcfg.loss_gains() == jcfg.loss_gains()
    assert "yolo7" in MODELS
    tcfg, _, _ = export_from_registry("yolo7")
    assert (tcfg.decode.conf_threshold, tcfg.decode.iou_threshold,
            tcfg.decode.max_det, tcfg.decode.pre_nms_topk) == (0.5, 0.3, 100,
                                                               4096)
