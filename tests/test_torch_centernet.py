"""CenterNet-DLA34: tpucv_torch against tpucv, module by module and as a
whole, in f32 on the CPU, at full width (head 256, nc 20) and small inputs.
Both packages get the same weights: the port's seeded init with every
BatchNorm, every conv bias and every ``up_k`` kernel drawn from a numpy seed
(the bilinear init is symmetric, so a flipped kernel would not show),
carried into flax by tpucv's ``import_centernet`` (which also skips
tpucv's ``jax.jit(model.init)``). Held:

- the config equal to tpucv's; the DLA-34 per-level parameter counts of
  ``tests/test_centernet.py`` and the whole model's 17,946,056 at nc 20;
- ``DepthwiseUp`` (a grouped ``ConvTranspose2d``) against tpucv's
  lhs-dilated, flipped-kernel conv at f = 2, 4 and 8, within 1e-5;
- the forward at 64² and 128² in eval mode, the heatmap, offset and size
  channels each within 1e-4 of their largest |value|; in train mode each
  within 2x the port's own f32 gap from its float64 run (as the YOLOv7
  tests bound it: ~55 batch-statistics BatchNorms renormalise the rounding
  before them) and a fixed ceiling; every BatchNorm's running statistics
  within 2x the port's own float64 gap (or 1e-5), and those of the dead
  ``project`` of level 3 and 4, which must move, within 1e-5;
- the weights across: the port's ``state_dict`` through tpucv's
  ``import_centernet`` and back through ``from_flax_variables``, exact and
  strict, and tpucv's own init (``jax.jit(model.init)``) through
  ``from_flax_variables`` loads with ``strict=True``; a reference ``.pth``
  loads through ``load_pretrained`` with no importer;
- ``gaussian_radius``: floors equal over 100,000 random boxes, values
  within 1e-5 cells and 1e-5 relative (XLA:CPU contracts the b² - 4ac into
  multiply-adds, so about one root in ten parts by an ulp, and the third
  root's b + sqrt cancels); the targets against tpucv's
  jitted ones: ind, mask, wh and reg equal, heatmap within 1e-6 (XLA's exp
  and PyTorch's part by an ulp), two boxes of one class max-merged, padded
  and zero-size rows splatting nothing;
- the focal, L1 and total loss within 1e-5 relative (64-128² inputs), and
  their gradient against ``jax.grad`` within 1e-4 of its largest element.
  At the shipped 96² map (B=3, 552,960 focal terms) XLA:CPU's f32 sum
  parts from the float64 sum of its own terms by 2.8e-5 relative while the
  port's stays within 1e-6: there the port's focal loss is held against
  float64;
- ``decode_centernet`` with and without DIoU NMS: on a planted peak, on
  random maps and on a map with fewer than K positive peaks (the zero
  rows in lowest-index order): valid and classes equal, boxes within
  1e-3 px, scores within 1e-5.

``test_torch_centernet_slice.py`` holds the algorithm, the trainer, int8
and the CLIs.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_yolov7 import randomize_bn
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt.importer import import_centernet
from tpucv.decode.centernet import decode_centernet as j_decode
from tpucv.losses.centernet import centernet_loss as j_loss
from tpucv.models.centernet import CenterNet as JCenterNet
from tpucv.models.centernet import DepthwiseUp as JDepthwiseUp
from tpucv.targets.centernet import build_centernet_targets as j_targets
from tpucv.targets.centernet import gaussian_radius as j_radius
from tpucv_torch.builder import export_from_registry
from tpucv_torch.check import MODELS
from tpucv_torch.ckpt.checkpoint import load_pretrained
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.decode.centernet import decode_centernet
from tpucv_torch.losses.centernet import centernet_loss
from tpucv_torch.models.centernet import CenterNet, DepthwiseUp
from tpucv_torch.targets.centernet import (build_centernet_targets,
                                           gaussian_radius)

torch.set_num_threads(1)
NC = 20
FWD_REL = 1e-4
TRAIN_FWD_X, TRAIN_FWD_CEIL = 2.0, 2e-3
BN_STAT_TOL = 1e-5
UP_TOL = 1e-5
HM_TOL = 1e-6
LOSS_REL, GRAD_TOL = 1e-5, 1e-4
DEC_TOL, BOX_PX_TOL = 1e-5, 1e-3
PARAMS = 17_946_056
LEVEL_PARAMS = {"base_layer": 2384, "level_0": 2336, "level_1": 4672,
                "level_2": 140032, "level_3": 1215488, "level_4": 4855808,
                "level_5": 9050112}


# ----------------------------------------------------------------- weights
def port_model(nc=NC, seed=0):
    """The port's seeded init with BatchNorm, conv biases and the upsample
    kernels drawn from a numpy seed."""
    model = CenterNet(nc).reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    randomize_bn(model, rng)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DepthwiseUp):
                m.weight.copy_(torch.from_numpy(rng.normal(
                    0.25, 0.1, m.weight.shape).astype(np.float32)))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.from_numpy(rng.normal(
                    0, 0.05, m.bias.shape).astype(np.float32)))
    return model.eval()


def numpy_sd(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@functools.lru_cache(maxsize=None)
def pair():
    """(tpucv module, tpucv variables, port model) with the same weights."""
    model = port_model()
    return JCenterNet(num_classes=NC), import_centernet(numpy_sd(model)), model


def _images(b=1, s=64, seed=0):
    return np.random.default_rng(seed).random((b, s, s, 3), np.float32)


def _parts(out):
    """heatmap logits, offsets, sizes of a raw (B, H, W, NC + 4) output."""
    return {"hm": out[..., :NC], "reg": out[..., NC:NC + 2],
            "wh": out[..., NC + 2:]}


# ------------------------------------------------------------------ config
def test_config_equals_tpucv():
    jcfg, _, _ = tpucv_export("centernet")
    tcfg, _, _ = export_from_registry("centernet")
    for sec in ("arch", "loss", "decode", "optimizer", "dataset", "train"):
        assert vars(getattr(tcfg, sec)) == vars(getattr(jcfg, sec)), sec
    assert tcfg.num_classes == jcfg.num_classes == NC
    assert (tcfg.arch.input_size, tcfg.arch.downsample,
            tcfg.arch.head_channels) == (384, 4, 256)
    assert (tcfg.decode.K, tcfg.decode.conf_threshold,
            tcfg.decode.use_diou_nms, tcfg.decode.iou_threshold) == (
        100, 0.1, True, 0.5)
    assert "centernet" in MODELS


# ----------------------------------------------------------------- network
def test_param_counts():
    _, variables, model = pair()
    assert sum(p.numel() for p in model.parameters()) == PARAMS
    assert sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"])) == PARAMS
    base = model.backbone.base
    assert {n: sum(p.numel() for p in m.parameters())
            for n, m in base.named_children()} == LEVEL_PARAMS
    flax_names = {"base": "base_layer", **{f"level{i}": f"level_{i}"
                                           for i in range(6)}}
    assert {flax_names[k]: sum(np.asarray(v).size for v in
                               jax.tree_util.tree_leaves(sub))
            for k, sub in variables["params"]["dla"].items()} == LEVEL_PARAMS


@pytest.mark.parametrize("f", [2, 4, 8])
def test_depthwise_up_equals_tpucv(f):
    rng = np.random.default_rng(f)
    C, H = 8, 5
    x = rng.normal(size=(2, H, H, C)).astype(np.float32)
    w = rng.normal(size=(C, 1, 2 * f, 2 * f)).astype(np.float32)
    ref = np.asarray(JDepthwiseUp(ch=C, f=f).apply(
        {"params": {"kernel": jnp.asarray(np.transpose(w, (2, 3, 1, 0)))}},
        jnp.asarray(x)))
    up = DepthwiseUp(C, f)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(w))
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, H * f, H * f, C)
    np.testing.assert_allclose(got, ref, rtol=UP_TOL, atol=UP_TOL)


def test_depthwise_up_init_is_tpucvs_bilinear():
    up = DepthwiseUp(3, 4)
    ref = JDepthwiseUp(ch=3, f=4).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 2, 2, 3)))
    np.testing.assert_allclose(
        up.weight.detach().numpy(),
        np.transpose(np.asarray(ref["params"]["kernel"]), (3, 2, 0, 1)),
        rtol=0, atol=1e-7)


@pytest.mark.parametrize("size", [64, 128])
def test_forward_eval_equal(size):
    jm, variables, model = pair()
    x = _images(s=size, seed=size)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, size // 4, size // 4, NC + 4)
    for k, r in _parts(ref).items():
        g = _parts(got)[k]
        assert np.abs(g - r).max() <= FWD_REL * np.abs(r).max(), k


def test_forward_train_and_bn_stats_equal():
    """One train-mode forward (B=2, 64²): outputs against tpucv within 2x
    the port's own f32 gap from float64 and a ceiling; every running
    statistic within 1e-5, the dead projects' too (they must move)."""
    jm, variables, model = pair()
    x = _images(b=2, seed=3)
    ref, upd = jax.jit(functools.partial(jm.apply, train=True,
                                         mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    m = copy.deepcopy(model).train()
    m64 = copy.deepcopy(model).double().train()
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
        exact = m64(torch.from_numpy(x).double()).numpy()
    ref = np.asarray(ref)
    for k, r in _parts(ref).items():
        own = np.abs(_parts(got)[k] - _parts(exact)[k]).max()
        err = np.abs(_parts(got)[k] - r).max()
        assert err <= max(TRAIN_FWD_X * own, FWD_REL * np.abs(r).max()), k
        assert err <= TRAIN_FWD_CEIL * np.abs(r).max(), k
    new_sd = from_flax_variables({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]})
    sd, sd64, before = m.state_dict(), m64.state_dict(), model.state_dict()
    n = 0
    for k, v in new_sd.items():
        if "running_" in k:
            own = np.abs(sd[k].numpy() - sd64[k].numpy()).max()
            err = np.abs(sd[k].numpy() - v.numpy()).max()
            assert err <= max(TRAIN_FWD_X * own, BN_STAT_TOL), k
            n += 1
    assert n == 2 * sum(isinstance(mod, torch.nn.BatchNorm2d)
                        for mod in m.modules())
    for lv in (3, 4):
        for stat in ("mean", "var"):
            k = f"backbone.base.level_{lv}.project.1.running_{stat}"
            assert not torch.equal(sd[k], before[k]), k
            np.testing.assert_allclose(sd[k].numpy(), new_sd[k].numpy(),
                                       rtol=0, atol=BN_STAT_TOL, err_msg=k)


def test_weights_round_trip_through_import_centernet():
    """The port's ``state_dict`` -> tpucv's ``import_centernet`` (whose tree
    ran the forwards above) -> ``from_flax_variables``: every tensor back
    exactly, strict; the up kernels (k, k, 1, C) <-> (C, 1, k, k)."""
    _, variables, model = pair()
    sd = from_flax_variables(variables)
    assert sorted(sd) == sorted(model.state_dict())
    fresh = CenterNet(NC)
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    up = variables["params"]["dla_up"]["ida_2"]["up_3"]["kernel"]
    assert up.shape == (4, 4, 1, 64)
    back = import_centernet(numpy_sd(fresh))
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(v, flat_b[path])


def test_tpucv_init_loads_strict():
    """tpucv's own init tree (its names and shapes, nc 4 at head 64 to keep
    the compile short) -> ``from_flax_variables`` -> ``strict=True``."""
    jm = JCenterNet(num_classes=4, head_channels=64)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    sd = from_flax_variables(v)
    model = CenterNet(4, head_channels=64)
    model.load_state_dict(sd, strict=True)
    assert sorted(sd) == sorted(model.state_dict())
    np.testing.assert_array_equal(
        model.backbone.heatmap[2].bias.detach().numpy(), np.float32(-2.19))


def test_reference_pth_loads_without_importer(tmp_path):
    _, _, model = pair()
    path = str(tmp_path / "ref.pth")
    torch.save(model.state_dict(), path)
    fresh = CenterNet(NC)
    load_pretrained(fresh, path, "centernet")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


# ----------------------------------------------------------------- targets
def test_gaussian_radius_equal():
    rng = np.random.default_rng(0)
    h = rng.uniform(0.1, 100, 100_000).astype(np.float32)
    w = rng.uniform(0.1, 100, 100_000).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: j_radius((a, b)))(h, w))
    got = gaussian_radius(torch.from_numpy(h), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.floor(got), np.floor(ref))


def _gt(seed, b=3, m=30, size=128, lo=2, hi=100):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, size, (b, m, 2))
    wh = rng.uniform(lo, hi, (b, m, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0,
                    size).astype(np.float32)
    labels = rng.integers(0, NC, (b, m)).astype(np.int32)
    mask = rng.random((b, m)) < 0.8
    return boxes, labels, mask


def _targets_both(boxes, labels, mask, hw):
    ref = jax.jit(functools.partial(j_targets, num_classes=NC,
                                    output_size=hw, downsample=4))(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    got = build_centernet_targets(torch.from_numpy(boxes),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask), NC, hw, 4)
    return ref, got


def _assert_targets_equal(boxes, labels, mask, hw=(32, 32)):
    ref, got = _targets_both(boxes, labels, mask, hw)
    for k in ("ind", "wh", "reg", "mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    hm = got.heatmap.numpy()
    assert hm.shape == (boxes.shape[0], *hw, NC)
    np.testing.assert_allclose(hm, np.asarray(ref.heatmap), rtol=0,
                               atol=HM_TOL)
    return got


@pytest.mark.parametrize("seed,size", [(0, 128), (1, 128), (2, 384)])
def test_targets_equal_over_seeds(seed, size):
    got = _assert_targets_equal(*_gt(seed, size=size, hi=size * 0.8),
                                hw=(size // 4, size // 4))
    assert (got.heatmap == 1.0).sum() >= got.mask.sum() * 0.5


def test_targets_two_boxes_of_one_class_max_merge():
    boxes = np.array([[[0.0, 0, 80, 80], [20.0, 20, 100, 100]]], np.float32)
    labels = np.array([[1, 1]], np.int32)
    mask = np.array([[True, True]])
    got = _assert_targets_equal(boxes, labels, mask)
    hm = got.heatmap[0, :, :, 1].numpy()
    assert hm[10, 10] == hm[15, 15] == 1.0 and hm.max() == 1.0
    assert got.heatmap[0, :, :, [0, 2]].max() == 0


def test_targets_padded_and_empty_rows_splat_nothing():
    boxes, labels, mask = _gt(4)
    boxes[:, 5] = [40.0, 40.0, 40.0, 90.0]          # no width
    mask[:, 5] = True
    mask[1] = False                                  # an empty image
    got = _assert_targets_equal(boxes, labels, mask)
    assert not got.mask[:, 5].any() and not got.mask[1].any()
    assert got.heatmap[1].max() == 0


# -------------------------------------------------------------------- loss
def _loss_inputs(seed, b=2, size=128):
    boxes, labels, mask = _gt(seed + 10, b=b, size=size, hi=size * 0.8)
    out = np.random.default_rng(seed).normal(
        0, 2, (b, size // 4, size // 4, NC + 4)).astype(np.float32)
    return out, boxes, labels, mask


@functools.lru_cache(maxsize=None)
def _j_loss_fns(hw):
    def f(out, boxes, labels, mask):
        t = j_targets(boxes, labels, mask, NC, hw, 4)
        return j_loss(out, t, NC)

    return jax.jit(f), jax.jit(jax.grad(lambda *a: f(*a)[0]))


def _port_loss(out, boxes, labels, mask):
    hw = tuple(out.shape[1:3])
    t = build_centernet_targets(torch.from_numpy(boxes),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask), NC, hw, 4)
    return centernet_loss(out, t, NC)


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 128), (2, 128)])
def test_loss_equal(seed, size):
    out, boxes, labels, mask = _loss_inputs(seed, size=size)
    rt, rp = _j_loss_fns(tuple(out.shape[1:3]))[0](out, boxes, labels, mask)
    gt, gp = _port_loss(torch.from_numpy(out), boxes, labels, mask)
    assert sorted(gp) == sorted(rp) == ["hm_loss", "off_loss", "wh_loss"]
    assert float(gt) == pytest.approx(float(rt), rel=LOSS_REL)
    for k in rp:
        assert float(gp[k]) == pytest.approx(float(rp[k]), rel=LOSS_REL), k
    assert float(gp["wh_loss"]) > 0


def test_loss_gradient_equal():
    out, boxes, labels, mask = _loss_inputs(5)
    ref = np.asarray(_j_loss_fns(tuple(out.shape[1:3]))[1](
        out, boxes, labels, mask))
    t = torch.from_numpy(out).requires_grad_()
    _port_loss(t, boxes, labels, mask)[0].backward()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(t.grad.numpy() - ref).max() <= GRAD_TOL * scale


def test_focal_at_the_shipped_map_against_float64():
    """96², B=3 (552,960 terms): the port's f32 focal loss within 1e-6
    relative of the same formula in float64 on the same logits and
    targets."""
    out, boxes, labels, mask = _loss_inputs(6, b=3, size=384)
    t = build_centernet_targets(torch.from_numpy(boxes),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask), NC, (96, 96), 4)
    got = float(centernet_loss(torch.from_numpy(out), t, NC)[1]["hm_loss"])
    x, ht = out[..., :NC].astype(np.float64), t.heatmap.numpy()
    p = np.clip(1 / (1 + np.exp(-x)), 1e-4, 1 - 1e-4)
    pos = ht >= 1.0 - 1e-6
    terms = np.where(pos, -np.log(p) * (1 - p) ** 2,
                     -np.log(1 - p) * p ** 2 * (1 - ht) ** 4)
    assert got == pytest.approx(terms.sum() / max(pos.sum(), 1), rel=1e-6)


def test_loss_on_a_perfect_map_is_lower():
    boxes = np.array([[[16.0, 16, 80, 80]]], np.float32)
    labels, mask = np.array([[0]], np.int32), np.array([[True]])
    t = build_centernet_targets(torch.from_numpy(boxes),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask), 3, (32, 32), 4)
    good = torch.zeros(1, 32, 32, 7)
    good[..., :3] = torch.where(t.heatmap >= 1.0, 9.0, -9.0)
    good[0, 12, 12, 3:5] = t.reg[0, 0]
    good[0, 12, 12, 5:] = t.wh[0, 0]
    bad = torch.zeros(1, 32, 32, 7)
    l_good, p_good = centernet_loss(good, t, 3)
    assert float(l_good) < float(centernet_loss(bad, t, 3)[0])
    assert float(p_good["wh_loss"]) == float(p_good["off_loss"]) == 0


# ------------------------------------------------------------------ decode
def _decode_both(out, diou, K=100, conf=0.1):
    kw = dict(downsample=4, K=K, conf_threshold=conf, use_diou_nms=diou,
              iou_threshold=0.5)
    ref = jax.jit(functools.partial(j_decode, num_classes=NC, **kw))(
        jnp.asarray(out))
    got = decode_centernet(torch.from_numpy(out), NC, **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_same_detections(ref, got):
    rb, rs, rc, rv = ref
    gb, gs, gc, gv = got
    assert gc.dtype == np.int32 and gv.dtype == np.bool_
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gc[gv], rc[rv])
    np.testing.assert_allclose(gs, rs, rtol=0, atol=DEC_TOL)
    np.testing.assert_allclose(gb[gv], rb[rv], rtol=0, atol=BOX_PX_TOL)


@pytest.mark.parametrize("diou", [True, False])
def test_decode_finds_a_planted_peak(diou):
    out = np.full((1, 32, 32, NC + 4), -9.0, np.float32)
    out[0, 10, 14, 1] = 9.0
    out[0, 10, 14, NC:NC + 2] = [0.5, 0.5]           # offsets
    out[0, 10, 14, NC + 2:] = [8.0, 6.0]             # sizes
    ref, got = _decode_both(out, diou, K=10, conf=0.3)
    _assert_same_detections(ref, got)
    (i,) = np.flatnonzero(got[3][0])
    assert got[2][0, i] == 1
    np.testing.assert_allclose(got[0][0, i], [42, 30, 74, 54], atol=1e-4)


@pytest.mark.parametrize("diou,seed", [(True, 0), (True, 1), (False, 2)])
def test_decode_equal_on_random_maps(diou, seed):
    rng = np.random.default_rng(seed)
    out = rng.normal(0, 2, (2, 32, 32, NC + 4)).astype(np.float32)
    out[..., NC + 2:] = np.abs(out[..., NC + 2:]) * 3
    ref, got = _decode_both(out, diou)
    assert got[3].sum() > 20
    _assert_same_detections(ref, got)


@pytest.mark.parametrize("diou", [True, False])
def test_decode_with_fewer_than_k_peaks(diou):
    """Six positive peaks an image (sigmoid exactly 1, and exactly 0
    everywhere else): the other 94 or more of the top 100 are zero-score
    rows, in lowest flat index order in both engines."""
    rng = np.random.default_rng(7)
    out = np.full((2, 24, 24, NC + 4), -200.0, np.float32)
    out[..., NC:] = rng.normal(0, 2, (2, 24, 24, 4))
    for b in range(2):
        for y, x, c in rng.integers(0, [24, 24, NC], (6, 3)):
            out[b, y, x, c] = 40.0
    ref, got = _decode_both(out, diou)
    _assert_same_detections(ref, got)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[0], ref[0])
    assert 0 < got[3].sum() <= 12
