"""tpucv_torch's legacy YOLOv3 (``models/yolov3.py``, ``losses/yolov3.py``,
``decode/yolov3.py``, ``trainer/yolov3_train.py``, ``Yolo3Config``)
against tpucv's, on the CPU in f32.

Both sides hold the same weights: the port's seed-0 init with BatchNorm
drawn from a seed (``randomize_bn``), as a tpucv tree under tpucv's own
names (``flax_tree``; tpucv has no YOLOv3 importer), which
``from_flax_variables`` carries back bit for bit.

- Forward at 64², nc 4, eval mode: each raw map within 5e-4 of its
  largest element (the golden tests' bound).
- Targets equal exactly (the assignment, xy offsets, objectness and
  classes; the log-size entries within 1e-6 relative: XLA's own f32 log
  parts from PyTorch's by an ulp on about 5% of inputs, as in
  ``test_torch_ssd.py``), on a batch where two GTs share a (cell, anchor)
  (tpucv's scatter keeps the later one), one GT lies outside the map
  (clipped into the edge cell) and an image holds padding only.
- The loss and its four terms within 1e-5 relative, and its gradient with
  respect to the raw maps within 1e-5 of each map's largest element.
- Decode (the multilabel NMS, K = 4,096 and K = 256): keep sets, classes
  and validity identical, scores within 1e-6, boxes within 1e-4 px.
- One trainer step against tpucv's at ``tests/test_module_zoo.py:
  144-158``'s config (64², M=4, B=2, f32): loss and terms within 1e-3
  relative (``REL_STEP`` of the other families' step tests: train-mode
  BatchNorm over 2 x 2 x 2 values a channel at stride 32 amplifies f32
  rounding; measured 1.2e-4), the weights after it within 2.1 x lr of
  tpucv's, the BatchNorm statistics' step within 1e-3 of tpucv's
  largest.
- The eval harness (``tests/test_yolov3.py:75``'s ``evaluate_on_voc`` on
  two synthetic 96² images): a model whose raw maps encode the images'
  GTs scores VOC mAP 1.0 through the port's letterbox, decode, NMS and
  metric, as through tpucv's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import Recorder
from test_torch_yolov8 import randomize_bn
from tpucv.configs.model_cfgs import Yolo3Config as JYolo3Config
from tpucv.decode.yolov3 import decode_yolov3 as j_decode
from tpucv.losses.yolov3 import make_yolov3_targets as j_targets
from tpucv.losses.yolov3 import yolov3_loss as j_loss
from tpucv.models.yolov3 import YoloV3 as JYoloV3
from tpucv.trainer.yolov3_train import Yolo3Algorithm as JYolo3Algorithm
from tpucv.trainer.yolov3_train import Yolo3Trainer as JYolo3Trainer
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.configs.model_cfgs import Yolo3Config
from tpucv_torch.decode.yolov3 import decode_yolov3
from tpucv_torch.losses.yolov3 import make_yolov3_targets, yolov3_loss
from tpucv_torch.models.yolov3 import YoloV3
from tpucv_torch.trainer.yolov3_train import Yolo3Algorithm, Yolo3Trainer

torch.set_num_threads(1)
ANCHORS = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                    [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)
MASK = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
STRIDES = (32, 16, 8)
NC = 4
S = 64


def flax_tree(sd):
    """A port ``state_dict`` as tpucv's ``YoloV3`` variables (numpy)."""
    params, stats = {}, {}
    for k, v in sd.items():
        *mod, leaf = k.split(".")
        if leaf == "num_batches_tracked":
            continue
        v = v.detach().cpu().numpy().copy()
        coll, name = (stats, {"running_mean": "mean",
                              "running_var": "var"}[leaf]) \
            if leaf.startswith("running") else (params, leaf)
        if leaf == "weight":
            name = "kernel" if v.ndim == 4 else "scale"
            if v.ndim == 4:
                v = np.transpose(v, (2, 3, 1, 0))
        node = coll
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = v
    return {"params": params, "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def pair(nc=NC):
    """(tpucv module, tpucv variables, port model in eval mode) with the
    same weights."""
    model = YoloV3(nc=nc).reset_parameters(torch.Generator().manual_seed(0))
    variables = randomize_bn(flax_tree(model.state_dict()),
                             np.random.default_rng(3))
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return JYoloV3(nc=nc), variables, model.eval()


def test_flax_tree_round_trips_through_from_flax_variables():
    _, variables, model = pair()
    sd = from_flax_variables(variables)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert "res3_7.cv2.bn.running_var" in sd and "y3_out.bias" in sd


def test_forward_matches_tpucv():
    jm, variables, model = pair()
    x = np.random.default_rng(0).random((2, S, S, 3), np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [
        (2, 2, 2, 27), (2, 4, 4, 27), (2, 8, 8, 27)]
    for g, r in zip(got, ref):
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max()
        assert err <= 5e-4 * np.abs(r).max(), err


def gt_batch(collide=True):
    """B=3, M=5: image 0 with two GTs on one (cell, anchor) and a GT
    whose centre lies outside the map; image 1 ordinary; image 2 with
    padding only."""
    boxes = np.zeros((3, 5, 4), np.float32)
    labels = np.zeros((3, 5), np.int32)
    mask = np.zeros((3, 5), bool)
    boxes[0, 0] = [20, 20, 44, 40]          # 24 x 20: anchor 2, stride 8
    boxes[0, 1] = [21, 19, 45, 41] if collide else [2, 2, 10, 10]
    boxes[0, 2] = [50, 60, 90, 100]          # centre (70, 80): off the map
    boxes[0, 3] = [0, 0, 63, 63]
    labels[0, :4] = [1, 3, 2, 0]
    mask[0, :4] = True
    boxes[1, :2] = [[5, 8, 30, 40], [30, 2, 60, 20]]
    labels[1, :2] = [2, 1]
    mask[1, :2] = True
    return boxes, labels, mask


@pytest.mark.parametrize("collide", [True, False])
def test_targets_equal_tpucv(collide):
    boxes, labels, mask = gt_batch(collide)
    shapes = [(2, 2), (4, 4), (8, 8)]
    ref = j_targets(jnp.asarray(boxes), jnp.asarray(labels),
                    jnp.asarray(mask), ANCHORS, MASK, STRIDES, shapes, NC)
    got = make_yolov3_targets(torch.from_numpy(boxes),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask), ANCHORS, MASK,
                              STRIDES, shapes, NC)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_array_equal(g[..., [0, 1, *range(4, 5 + NC)]],
                                      r[..., [0, 1, *range(4, 5 + NC)]])
        np.testing.assert_allclose(g[..., 2:4], r[..., 2:4], rtol=1e-6,
                                   atol=0)
    # the collision: one positive, the later GT's class (3)
    t = got[2][0]
    pos = t[..., 4] > 0.5
    if collide:
        assert int(pos[3:5, 3:5].sum()) == 1
        assert int(t[pos][:, 5:].argmax(-1).eq(3).sum()) >= 1
    assert float(sum(g[2, ..., 4].sum() for g in got)) == 0.0


def _maps(seed=5, B=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, h, h, 3 * (5 + NC))) * 2).astype(np.float32)
            for h in (2, 4, 8)]


def test_loss_terms_and_gradients_equal_tpucv():
    boxes, labels, mask = gt_batch()
    maps = _maps()

    def j_total(ms):
        return j_loss(ms, jnp.asarray(boxes), jnp.asarray(labels),
                      jnp.asarray(mask), ANCHORS, MASK, STRIDES, NC)

    (j_tot, j_terms), j_grads = jax.jit(jax.value_and_grad(
        j_total, has_aux=True))([jnp.asarray(m) for m in maps])
    tm = [torch.from_numpy(m).requires_grad_() for m in maps]
    tot, terms = yolov3_loss(tm, torch.from_numpy(boxes),
                             torch.from_numpy(labels), torch.from_numpy(mask),
                             ANCHORS, MASK, STRIDES, NC)
    tot.backward()
    assert float(tot) == pytest.approx(float(j_tot), rel=1e-5)
    assert terms.keys() == j_terms.keys()
    for k in terms:
        assert float(terms[k]) == pytest.approx(float(j_terms[k]), rel=1e-5)
    for g, r in zip(tm, j_grads):
        r = np.asarray(r)
        assert np.abs(g.grad.numpy() - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("topk", [4096, 256])
def test_decode_equals_tpucv(topk):
    maps = _maps(seed=9, B=2)
    for m in maps:           # objectness and classes sharpened
        v = m.reshape(*m.shape[:3], 3, 5 + NC)
        v[..., 4:] *= 4.0
    ref = [np.asarray(t) for t in jax.jit(
        lambda ms: j_decode(ms, ANCHORS, MASK, STRIDES, NC, 0.3, 0.45, 20,
                            topk))([jnp.asarray(m) for m in maps])]
    got = [t.numpy() for t in decode_yolov3(
        [torch.from_numpy(m) for m in maps], ANCHORS, MASK, STRIDES, NC, 0.3,
        0.45, 20, topk)]
    b_r, s_r, c_r, v_r = ref
    b_g, s_g, c_g, v_g = got
    assert v_r.sum() > 5
    np.testing.assert_array_equal(v_g, v_r)
    np.testing.assert_array_equal(c_g[v_g], c_r[v_r])
    np.testing.assert_allclose(s_g[v_g], s_r[v_r], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b_g[v_g], b_r[v_r], rtol=0, atol=1e-4)


def _zoo_cfg(cfg, root):
    """``tests/test_module_zoo.py:144-158``'s config."""
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = 2
    cfg.train.epochs = 1
    cfg.train.eval_interval = 1000
    cfg.train.save_interval = 1000
    cfg.train.mixed_precision = False
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    return cfg


def test_trainer_step_equals_tpucv(tmp_path, monkeypatch):
    """Both trainers from the port's seed-0 init (tpucv's
    ``init_variables`` returns it as a tpucv tree), one step on the
    synthetic set's first batch. Neither writes its checkpoints (four
    Darknet-53 bundles with Adam's moments, 2.8 GB): the step is what is
    compared."""
    from tpucv.ckpt.checkpoint import CheckPoint as JCheckPoint
    from tpucv_torch.ckpt.checkpoint import CheckPoint

    for cls in (JCheckPoint, CheckPoint):
        monkeypatch.setattr(cls, "save",
                            staticmethod(lambda state, path: path))
    t = Yolo3Trainer(_zoo_cfg(Yolo3Config(), tmp_path / "port"),
                     device="cpu")
    tree = flax_tree(t.model.state_dict())
    monkeypatch.setattr(JYolo3Algorithm, "init_variables",
                        lambda self, model=None, seed=0: tree)
    j = JYolo3Trainer(_zoo_cfg(JYolo3Config(), tmp_path / "tpucv"))
    j.tb, t.tb = Recorder(), Recorder()
    j_state = j.train(max_steps=1)
    t_state = t.train(max_steps=1)
    assert t_state.step == int(j_state.step) == 1
    for k in ("loss", "xy_loss", "wh_loss", "obj_loss", "cls_loss"):
        np.testing.assert_allclose(t.tb.rows[f"train/{k}"][1],
                                   j.tb.rows[f"train/{k}"][1], rtol=1e-3,
                                   err_msg=k)
    assert t.tb.rows["train/cls_loss"][1] > 0
    lr = t.tb.rows["lr"][1]
    assert lr == pytest.approx(j.tb.rows["lr"][1], rel=1e-6)
    before = from_flax_variables(tree)
    after = from_flax_variables({"params": j_state.params,
                                 "batch_stats": j_state.batch_stats})
    for k, v in t_state.model.state_dict().items():
        if "num_batches" in k:
            continue
        # the running statistics' step within REL_STEP of tpucv's
        bound = (1e-3 * float((after[k] - before[k]).abs().max()) + 1e-7
                 if "running" in k else 2.1 * lr)
        assert float((v - after[k]).abs().max()) <= bound, k


def _encoding_maps(boxes, labels, mask, cfg, nc):
    """Raw maps whose decode is the GTs: each GT's target cell and anchor
    with its in-cell offset through the logit, its log-size, objectness
    and its class at +12, everything else at -12."""
    shapes = [(cfg.dataset.input_size // s,) * 2 for s in cfg.arch.strides]
    ts = make_yolov3_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                             torch.from_numpy(mask),
                             np.asarray(cfg.arch.anchors, np.float32),
                             cfg.arch.anchor_mask, cfg.arch.strides, shapes,
                             nc)
    out = []
    for t in ts:
        pos = t[..., 4:5] > 0.5
        xy = torch.logit(t[..., :2].clamp(1e-4, 1 - 1e-4))
        rest = torch.where(t[..., 4:] > 0.5, 12.0, -12.0)
        raw = torch.where(pos, torch.cat([xy, t[..., 2:4], rest], -1),
                          torch.full_like(t, -12.0))
        out.append(raw.reshape(*t.shape[:3], -1))
    return out


class Encoder(torch.nn.Module):
    """Stands in for the network: the raw maps of ``maps`` for a batch
    (the harness's batch of two), whatever the images."""

    def __init__(self, maps):
        super().__init__()
        self.maps = maps

    def forward(self, x):
        return tuple(m[:x.shape[0]] for m in self.maps)


def test_eval_harness_scores_encoded_ground_truth():
    from tpucv.data.detection_dataset import SyntheticDetectionIndex
    from tpucv_torch.data.detection_dataset import (
        SyntheticDetectionIndex as TSynthetic)

    cfg = Yolo3Config()
    cfg.dataset.name = "voc"
    cfg.dataset.input_size = 96
    cfg.train.mixed_precision = False
    cfg.decode.pre_nms_topk = 128
    cfg.decode.max_det = 10
    index = TSynthetic(2, 96, 20, max_objects=2, seed=7)
    boxes = np.zeros((2, 4, 4), np.float32)
    labels = np.zeros((2, 4), np.int32)
    mask = np.zeros((2, 4), bool)
    for i in range(2):
        _, b, lab = index[i]
        boxes[i, :len(b)], labels[i, :len(lab)] = b, lab
        mask[i, :len(lab)] = True
    algo = Yolo3Algorithm(cfg, device="cpu")
    maps = _encoding_maps(boxes, labels, mask, cfg, algo.nc)
    res = algo.evaluate_on_voc(Encoder(maps), index, batch_size=2,
                               conf_threshold=0.001, verbose=False)
    assert res["mAP"] == pytest.approx(1.0)

    jcfg = JYolo3Config()
    jcfg.dataset.name = "voc"
    jcfg.dataset.input_size = 96
    jcfg.train.mixed_precision = False
    jcfg.decode.pre_nms_topk = 128
    jcfg.decode.max_det = 10
    jalgo = JYolo3Algorithm(jcfg)
    jmaps = [jnp.asarray(m.numpy()) for m in maps]

    class JEncoder:
        def apply(self, variables, x):
            return tuple(m[:x.shape[0]] for m in jmaps)

    jalgo.build_model = lambda: JEncoder()
    jres = jalgo.evaluate_on_voc({}, SyntheticDetectionIndex(
        2, 96, 20, max_objects=2, seed=7), batch_size=2,
        conf_threshold=0.001, verbose=False)
    assert res["mAP"] == pytest.approx(jres["mAP"], abs=1e-9)
