"""YOLOv8-pose: tpucv_torch against tpucv, module by module and as a
whole, in f32 on the CPU, both packages from the same weights (tpucv's
init, BatchNorm statistics drawn from a numpy seed, carried across with
``from_flax_variables``). Held:

- the forward (``Yolo8(head="pose")``, YOLOv8n, nc=1, at 160): detect
  and keypoint maps within 5e-4; the parameter count equal to tpucv's,
  3,295,470;
- ``decode_kpts_flat`` within 1e-4 px; ``decode_pose`` at input 160
  (``nms_keep``'s plain version) and 256 (the scan): valid, classes and
  anchor indices equal; scores and visibilities within 1e-5, boxes and
  keypoint xy within 1e-4 px plus 1e-6 relative (``test_torch_seg.py``
  says why), on the valid rows;
- ``keypoint_loss`` within 1e-6 relative; ``yolov8_pose_loss`` at B=2,
  128²: the total and each term (``kpt_loss``, ``kobj_loss``) within 1e-4
  relative, the gradients of every raw output within 1e-5 absolute, with
  fewer and more foreground anchors than ``pose_topk``, padded GT rows,
  an image without GTs and invisible keypoints;
- ``SyntheticPoseIndex``, ``COCOKeypointIndex`` (a JSON fixture with a
  crowd and a keypoint-less person) and ``PoseDataset`` byte-equal;
- ``COCOKeypointAP`` stats within 1e-12 on the same records, crowd and
  keypoint-less GTs included;
- the slice: ``predict`` (detections; keypoints within 1e-4 px),
  ``evaluate_on_coco`` (box and OKS stats within 1e-12, against GTs made
  from tpucv's own detections so the stats are not all 0), with the class
  branch sharpened; one and two trainer steps (1e-4 and 1e-3 relative, as
  in ``test_torch_seg.py``); the train, predict and evaluate CLIs' ``main``
  on the CPU.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seg import (BOX_PX_TOL, BOX_RTOL, DEC_TOL, FWD_TOL,
                            GRAD_TOL, LOSS_REL, REL_STEP1, REL_STEP2, SIZE,
                            STAT_TOL, _write_png)
from test_torch_trainer import Recorder
from test_torch_yolov8 import randomize_bn
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.data.pose_dataset import COCOKeypointIndex as JKptIndex
from tpucv.data.pose_dataset import PoseDataset as JPoseDS
from tpucv.data.pose_dataset import SyntheticPoseIndex as JSynthPose
from tpucv.decode import yolov8 as jd
from tpucv.decode.yolov8_pose import decode_pose as j_decode_pose
from tpucv.losses.extras import keypoint_loss as j_keypoint_loss
from tpucv.losses.yolov8_pose import decode_kpts_flat as j_decode_kpts
from tpucv.losses.yolov8_pose import yolov8_pose_loss as j_pose_loss
from tpucv.metrics.coco_map import COCOKeypointAP as JKptAP
from tpucv.models.yolov8 import Yolo8 as FlaxYolo8
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.data.pose_dataset import (COCOKeypointIndex, PoseDataset,
                                           SyntheticPoseIndex, pose_collate)
from tpucv_torch.decode import yolov8 as td
from tpucv_torch.decode.yolov8_pose import decode_pose
from tpucv_torch.losses.extras import keypoint_loss
from tpucv_torch.losses.yolov8_pose import decode_kpts_flat, yolov8_pose_loss
from tpucv_torch.metrics.coco_map import COCOKeypointAP, OKS_SIGMAS
from tpucv_torch.models.yolov8 import Yolo8

torch.set_num_threads(1)
NK = 17
CLS_GAIN = 3000.0


@pytest.fixture(scope="module")
def weights():
    fm = FlaxYolo8(scale="n", nc=1, head="pose")
    v = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.default_rng(0)
    variables = {"params": randomize_bn(v["params"], rng),
                 "batch_stats": randomize_bn(v["batch_stats"], rng)}
    model = Yolo8("n", nc=1, head="pose")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return fm, variables, model.eval()


def test_forward_matches_flax(weights):
    fm, variables, model = weights
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3), dtype=np.float32)
    ref = jax.jit(fm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        det, kpts = model(torch.from_numpy(x))
    assert tuple(kpts[0].shape) == (2, SIZE // 8, SIZE // 8, NK * 3)
    for o, r in zip([*det, *kpts], [*ref[0], *ref[1]]):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=FWD_TOL,
                                   rtol=0)


def test_parameters_and_keys(weights):
    _, variables, model = weights
    n = sum(np.size(x) for x in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n == sum(p.numel() for p in model.parameters()) == 3_295_470
    keys = model.state_dict().keys()
    for k in ("model.22.cv2.0.0.conv.weight", "model.22.cv3.1.2.weight",
              "model.22.cv4.2.2.bias", "model.22.dfl.conv.weight"):
        assert k in keys, k
    assert not any(".proto." in k for k in keys)
    assert model.model[22].cv4[0][0].conv.out_channels == 51   # max(16, 51)


def _raw(S, seed, B=2, nc=1):
    rng = np.random.default_rng(seed)
    det, kpts = [], []
    for s in (8, 16, 32):
        m = rng.normal(0, 2.0, (B, S // s, S // s, 64 + nc))
        m[..., 64:] -= 1.0
        det.append(m.astype(np.float32))
        kpts.append(rng.normal(0, 1, (B, S // s, S // s, NK * 3))
                    .astype(np.float32))
    return det, kpts


def test_decode_kpts_flat():
    _, kpts = _raw(128, seed=1)
    ref = np.asarray(j_decode_kpts([jnp.asarray(m) for m in kpts], (NK, 3),
                                   (8, 16, 32)))
    got = decode_kpts_flat([torch.from_numpy(m) for m in kpts], (NK, 3),
                           (8, 16, 32)).numpy()
    assert got.shape == ref.shape == (2, 336, NK, 3)
    np.testing.assert_allclose(got, ref, atol=BOX_PX_TOL,
                               rtol=BOX_RTOL)


@pytest.mark.parametrize("S", [160, 256], ids=["nms_plain", "scan"])
def test_decode_pose_matches(S):
    det, kpts = _raw(S, seed=S)
    jraw = ([jnp.asarray(m) for m in det], [jnp.asarray(m) for m in kpts])
    traw = ([torch.from_numpy(m) for m in det],
            [torch.from_numpy(m) for m in kpts])
    ref = [np.asarray(x) for x in j_decode_pose(jraw)]
    got = [x.numpy() for x in decode_pose(traw)]
    j_idx = np.asarray(jd.decode_boxes(jraw[0], nc=1, return_idx=True)[4])
    t_idx = td.decode_boxes(traw[0], nc=1, return_idx=True)[4].numpy()
    v = ref[3]
    assert v.sum() > 20
    np.testing.assert_array_equal(got[3], v)
    np.testing.assert_array_equal(got[2][v], ref[2][v])
    np.testing.assert_array_equal(t_idx[v], j_idx[v])
    np.testing.assert_allclose(got[0][v], ref[0][v], atol=BOX_PX_TOL,
                               rtol=BOX_RTOL)
    np.testing.assert_allclose(got[1][v], ref[1][v], atol=DEC_TOL, rtol=0)
    np.testing.assert_allclose(got[4][v][..., :2], ref[4][v][..., :2],
                               atol=BOX_PX_TOL,
                               rtol=BOX_RTOL)
    np.testing.assert_allclose(got[4][v][..., 2], ref[4][v][..., 2],
                               atol=DEC_TOL, rtol=0)


def test_keypoint_loss():
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 100, (2, 5, NK, 2)).astype(np.float32)
    gt = rng.uniform(0, 100, (2, 5, NK, 2)).astype(np.float32)
    vis = (rng.random((2, 5, NK)) < 0.7).astype(np.float32)
    area = rng.uniform(1, 3000, (2, 5)).astype(np.float32)
    sig = OKS_SIGMAS.astype(np.float32)
    ref = float(j_keypoint_loss(*(jnp.asarray(a) for a in
                                  (pred, gt, vis, area, sig))))
    got = keypoint_loss(*(torch.from_numpy(a) for a in
                          (pred, gt, vis, area, sig))).item()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


LOSS_CASES = {"few_fg": 3, "many_fg": 16, "padded": 8, "empty_image": 6}


def _loss_inputs(case, B=2, S=128):
    M = LOSS_CASES[case]
    det, kpts = _raw(S, seed=list(LOSS_CASES).index(case) + 20, B=B)
    rng = np.random.default_rng(list(LOSS_CASES).index(case))
    xy = rng.uniform(0, S * 0.6, (B, M, 2))
    wh = rng.uniform(12, S * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = np.zeros((B, M), np.int32)
    mask = np.ones((B, M), bool)
    if case == "padded":
        mask[0, 5:] = False
        mask[1, 2:] = False
        boxes[~mask] = 0.0
    elif case == "empty_image":
        mask[1] = False
    f = rng.random((B, M, NK, 2))
    lo, hi = boxes[..., None, :2], boxes[..., None, 2:]
    gk = lo + f * (hi - lo)
    vis = rng.choice([0.0, 1.0, 2.0], (B, M, NK, 1), p=[0.3, 0.2, 0.5])
    gt_kpts = np.concatenate([gk, vis], -1).astype(np.float32)
    return (det, kpts), labels, boxes, mask, gt_kpts


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_pose_loss_value_terms_and_gradients(case):
    (det, kpts), labels, boxes, mask, gt_kpts = _loss_inputs(case)

    def f(d, k):
        return j_pose_loss((d, k), jnp.asarray(labels), jnp.asarray(boxes),
                           jnp.asarray(mask), jnp.asarray(gt_kpts))

    (ref, ref_m), ref_g = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        [jnp.asarray(m) for m in det], [jnp.asarray(m) for m in kpts])
    td_ = [torch.from_numpy(m).requires_grad_() for m in det]
    tk_ = [torch.from_numpy(m).requires_grad_() for m in kpts]
    got, got_m = yolov8_pose_loss(
        (td_, tk_), torch.from_numpy(labels), torch.from_numpy(boxes),
        torch.from_numpy(mask), torch.from_numpy(gt_kpts))
    got.backward()
    n_fg = float(ref_m["num_fg"])
    if case == "few_fg":
        assert 0 < n_fg < 2 * 64
    if case == "many_fg":
        assert n_fg > 2 * 64
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_REL)
    for k in ("box_loss", "cls_loss", "dfl_loss", "kpt_loss", "kobj_loss"):
        np.testing.assert_allclose(got_m[k].item(), float(ref_m[k]),
                                   rtol=LOSS_REL, atol=1e-7, err_msg=k)
    assert got_m["num_fg"].item() == n_fg
    assert got_m["kpt_loss"].item() > 0 and got_m["kobj_loss"].item() > 0
    for t, r in zip([*td_, *tk_], [*ref_g[0], *ref_g[1]]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_TOL, rtol=0)


def _kpt_json(root):
    """person_keypoints-style JSON over three PNGs (one not square), with a
    crowd person and a keypoint-less one (eval-only)."""
    rng = np.random.default_rng(3)
    images = [{"id": 10 + i, "file_name": f"p{i}.png", "height": h,
               "width": w} for i, (h, w) in enumerate(
                   [(96, 128), (120, 120), (80, 100)])]
    anns, k = [], 0

    def kp(box):
        x, y, w, h = box
        pts = np.stack([x + rng.random(NK) * w, y + rng.random(NK) * h,
                        rng.choice([0, 1, 2], NK)], -1)
        return [float(v) for v in pts.reshape(-1)]

    for im in images:
        for _ in range(2):
            k += 1
            box = [float(rng.uniform(0, 40)), float(rng.uniform(0, 30)),
                   float(rng.uniform(10, 50)), float(rng.uniform(10, 40))]
            kps = kp(box)
            anns.append({"id": k, "image_id": im["id"], "category_id": 1,
                         "iscrowd": 0, "bbox": box, "keypoints": kps,
                         "num_keypoints": int(sum(v > 0 for v in kps[2::3])),
                         "area": box[2] * box[3] * 0.8})
    anns.append({"id": 90, "image_id": 10, "category_id": 1, "iscrowd": 1,
                 "bbox": [0, 0, 30, 30], "num_keypoints": 0,
                 "keypoints": [0.0] * 51, "area": 700.0})
    anns.append({"id": 91, "image_id": 11, "category_id": 1, "iscrowd": 0,
                 "bbox": [60, 60, 20, 20], "num_keypoints": 0,
                 "keypoints": [0.0] * 51})
    (root / "kp.json").write_text(json.dumps(
        {"images": images, "annotations": anns,
         "categories": [{"id": 1, "name": "person"}]}))
    for i, im in enumerate(images):
        _write_png(root / im["file_name"], im["height"], im["width"], i)
    return str(root / "kp.json"), str(root)


def _equal(a, b, what):
    assert type(a) is type(b) or isinstance(a, np.ndarray), what
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("source", ["synthetic", "coco_keypoints"])
def test_pose_indices_and_dataset_byte_equal(source, tmp_path):
    if source == "synthetic":
        j_idx, t_idx = JSynthPose(4, 96, NK, seed=3), \
            SyntheticPoseIndex(4, 96, NK, seed=3)
    else:
        ann, root = _kpt_json(tmp_path)
        j_idx, t_idx = JKptIndex(ann, root), COCOKeypointIndex(ann, root)
        assert len(t_idx) == 3
    assert len(j_idx) == len(t_idx)
    assert tuple(t_idx.cat_ids) == tuple(j_idx.cat_ids)
    for i in range(len(t_idx)):
        _equal(t_idx[i], j_idx[i], f"item {i}")
        _equal(t_idx.keypoints(i), j_idx.keypoints(i), f"kpts {i}")
        _equal(t_idx.image_id(i), j_idx.image_id(i), f"id {i}")
        _equal(t_idx.eval_gt_records(i), j_idx.eval_gt_records(i),
               f"records {i}")
    j_ds, t_ds = JPoseDS(j_idx, 64, 4, nk=NK), PoseDataset(t_idx, 64, 4, nk=NK)
    for i in range(len(t_ds)):
        _equal(t_ds[i], j_ds[i], f"dataset item {i}")
    assert pose_collate([t_ds[0], t_ds[1]])["gt_kpts"].shape == (2, 4, NK, 3)


def _kpt_records(seed, n_img=4):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for i in range(n_img):
        for g in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0, 100, 2)
            w, h = rng.uniform(20, 150, 2)
            kp = np.stack([x + rng.random(NK) * w, y + rng.random(NK) * h,
                           rng.choice([0, 2], NK, p=[0.3, 0.7])], -1)
            if g == 2:
                kp[:, 2] = 0                  # keypoint-less: ignored
            gts.append({"image_id": i, "category_id": 1,
                        "bbox": [x, y, w, h], "area": w * h * 0.7,
                        "iscrowd": int(rng.random() < 0.15),
                        "keypoints": kp.reshape(-1).astype(np.float32),
                        "num_keypoints": int((kp[:, 2] > 0).sum())})
            for _ in range(2):
                noisy = kp.copy()
                noisy[:, :2] += rng.normal(0, rng.uniform(1, 15), (NK, 2))
                dts.append({"image_id": i, "category_id": 1,
                            "keypoints": noisy.reshape(-1).astype(np.float32),
                            "score": float(rng.random())})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_keypoint_ap_same_stats(seed):
    gts, dts = _kpt_records(seed)
    ref = JKptAP(gts, dts, (1,)).accumulate().summarize()
    got = COCOKeypointAP(gts, dts, (1,)).accumulate().summarize()
    assert got.keys() == ref.keys() and len(got) == 10
    assert max(got.values()) > 0
    for k in ref:
        assert abs(got[k] - ref[k]) <= STAT_TOL, k
    assert COCOKeypointAP(gts, dts, (1,))._accumulate_native() is False


# ------------------------------------------------------ the slice as a whole
def _algos(size=SIZE):
    jcfg, j_cls, _ = tpucv_export("yolo8_pose")
    tcfg, t_cls, _ = export_from_registry("yolo8_pose")
    for cfg in (jcfg, tcfg):
        cfg.train.mixed_precision = False
        cfg.dataset.input_size = size
    j, t = j_cls(jcfg), t_cls(tcfg, device="cpu")
    variables = j.init_variables()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for lv in range(3):
        head = params["pose"]["detect"][f"cv3_{lv}_2"]
        head["bias"] = np.zeros_like(head["bias"])
        head["kernel"] = head["kernel"] * CLS_GAIN
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    model = t.init_variables()
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return j, variables, t, model


@pytest.fixture(scope="module")
def pair():
    return _algos()


def test_predict_equals_tpucv(pair, tmp_path):
    j, variables, t, model = pair
    src = str(tmp_path / "img.png")
    _write_png(src, 120, 160, 5)
    ref = j.predict(variables, src, save_dir=str(tmp_path / "j"))
    got = t.predict(model, src, save_dir=str(tmp_path / "t"))
    assert len(ref["classes"]) > 0
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5,
                               rtol=0)
    assert got["keypoints"].shape == (len(ref["classes"]), NK, 3)
    np.testing.assert_allclose(got["keypoints"], ref["keypoints"],
                               atol=BOX_PX_TOL,
                               rtol=BOX_RTOL)
    assert got["saved"].split("/")[-1].startswith("img_pose@")
    assert cv2.imread(got["saved"]).shape == (120, 160, 3)


class PseudoGTIndex(SyntheticPoseIndex):
    """A synthetic pose index whose GT records are given: both packages'
    detections are scored against GTs made from tpucv's own."""

    def __init__(self, records, *a, **kw):
        super().__init__(*a, **kw)
        self.records = records

    def eval_gt_records(self, i):
        return self.records.get(i, [])


def test_evaluate_on_coco_equals_tpucv(pair, tmp_path):
    j, variables, t, model = pair
    idx = SyntheticPoseIndex(6, 140, NK, seed=5)
    records = {}
    for i, boxes, scores, _, kpts in j._batched_pose_detections(
            variables, JSynthPose(6, 140, NK, seed=5), 4, 0.001):
        order = np.argsort(-np.asarray(scores), kind="stable")[:3]
        for k in order:
            b, kp = np.asarray(boxes[k]), np.asarray(kpts[k]).copy()
            kp[:, 2] = 2.0
            w, h = float(b[2] - b[0]), float(b[3] - b[1])
            records.setdefault(i, []).append({
                "image_id": i, "category_id": 1,
                "bbox": [float(b[0]), float(b[1]), w, h], "area": w * h,
                "iscrowd": 0, "keypoints": kp.reshape(-1),
                "num_keypoints": NK})
    assert len(records) == len(idx)
    kw = dict(batch_size=4, verbose=False)
    ref = j.evaluate_on_coco(variables, PseudoGTIndex(records, 6, 140, NK, 5),
                             result_dir=str(tmp_path / "j"), **kw)
    got = t.evaluate_on_coco(model, PseudoGTIndex(records, 6, 140, NK, 5),
                             result_dir=str(tmp_path / "t"), **kw)
    assert got.keys() == ref.keys() and len(got) == 22
    assert got["AP"] > 0.5 and got["kpt_AP"] > 0.5
    for k in ref:
        assert abs(got[k] - ref[k]) <= STAT_TOL, k
    dts = json.loads((tmp_path / "t" / "eval_results.json").read_text())
    assert len(dts) > 0 and len(dts[0]["keypoints"]) == NK * 3


def _shrink(cfg, root):
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = 2
    cfg.train.mixed_precision = False
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.loss.pose_topk = 8
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    return cfg


def test_trainer_steps_equal_tpucv(tmp_path):
    jcfg, _, j_cls = tpucv_export("yolo8_pose")
    j = j_cls(_shrink(jcfg, tmp_path / "tpucv"))
    tcfg, _, t_cls = export_from_registry("yolo8_pose")
    t = t_cls(_shrink(tcfg, tmp_path / "port"), device="cpu")
    t.model.load_state_dict(from_flax_variables(
        {"params": j.init_params, "batch_stats": j.init_batch_stats}))
    j.tb, t.tb = Recorder(), Recorder()
    j.train(max_steps=2)
    t.train(max_steps=2)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "kpt_loss",
              "kobj_loss"):
        for step, rel in ((1, REL_STEP1), (2, REL_STEP2)):
            np.testing.assert_allclose(
                t.tb.rows[f"train/{k}"][step], j.tb.rows[f"train/{k}"][step],
                rtol=rel, err_msg=f"{k} step {step}")
    assert t.tb.rows["train/num_fg"][1] == j.tb.rows["train/num_fg"][1]


def test_clis_on_the_cpu(monkeypatch, tmp_path, capsys):
    from tpucv_torch import evaluate, predict
    from tpucv_torch.train import __main__ as train

    def shrunk(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.dataset.input_size = SIZE
        cfg.train.mixed_precision = False
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate, train):
        monkeypatch.setattr(mod, "export_from_registry", shrunk)
    train.main(["--model", "yolo8_pose", "--device", "cpu", "--max-steps",
                "1", "--batch-size", "2"])
    ckpt = str(tmp_path / "saves" / "yolo8_pose_coco_final.ckpt")
    src = str(tmp_path / "a.png")
    _write_png(src, 100, 150, 9)
    out = predict.main(["--model", "yolo8_pose", "--device", "cpu",
                        "--ckpt", ckpt, "--src", src, "--dst", "drawn"])
    assert "keypoints" in out[0] and out[0]["saved"]
    assert "a.png: " in capsys.readouterr().out
    stats = evaluate.main(["--model", "yolo8_pose", "--device", "cpu",
                           "--batch-size", "8", "--ckpt", ckpt])
    assert len(stats) == 22 and "kpt_AP" in stats
    assert (tmp_path / "result" / "eval_results.json").is_file()
