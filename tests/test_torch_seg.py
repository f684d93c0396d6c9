"""YOLOv8-seg: tpucv_torch against tpucv, module by module and as a
whole, in f32 on the CPU. Both packages start from the same weights:
tpucv's init (BatchNorm statistics drawn from a numpy seed) carried into
the port with ``from_flax_variables``. Held:

- the forward (``Yolo8(head="segment")``, YOLOv8n at 160): detect maps,
  mask coefficients and prototypes within 5e-4 (tpucv's golden bound);
  the parameter count equal to tpucv's, 4,063,984 at nc=80;
- ``decode_seg`` on numpy-seeded raw outputs at input 160 (525 anchors:
  ``nms_keep``'s plain version) and 256 (1,344: the scan): valid,
  classes and anchor indices equal; scores and coefficients within 1e-5
  and boxes within 1e-4 px plus 1e-6 relative on the valid rows (the DFL
  expectation sums its 16 bins in another order, and the stride, up to
  32, scales that last-bit difference: 3.1e-5 px measured near 0, and 4
  ulps, 1.2e-4 px, at 290 px);
- ``yolov8_seg_loss`` at B=2, 128²: the total and each term within 1e-4
  relative, ``num_fg`` equal, the gradients of every raw output within
  1e-5 absolute (the detect loss's bound, ``test_torch_yolov8_loss.py``),
  with fewer than ``mask_topk`` foreground anchors (the top-k ties at -1
  decide which background anchors fill the rest), with more, with padded
  GT rows and with an image that has none;
- ``InstanceSegDataset`` items byte-equal, box-filled (synthetic index)
  and polygon-filled (a COCO fixture with ``keep_polys``);
- ``COCOMaskAP`` stats within 1e-12 on the same records, crowd included;
- the slice: ``predict`` (detections, masks as bools), ``evaluate_mask_ap``
  (stats within 1e-12) with the class branch sharpened as the predict
  tests do, one and two trainer steps (the loss and its terms within
  1e-4 relative at step 1, the loss bound above: measured 2.2e-5 on a
  box_loss of 0.077, which the forward's f32 summation order moves; 1e-3
  at step 2, after one update, as ``test_torch_trainer.py`` has it), and
  the train,
  predict and evaluate CLIs' ``main`` on the CPU.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import Recorder
from test_torch_yolov8 import randomize_bn
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.data.coco import COCOIndex as JCOCOIndex
from tpucv.data.detection_dataset import \
    SyntheticDetectionIndex as JSynthIndex
from tpucv.data.instance_seg_dataset import InstanceSegDataset as JSegDS
from tpucv.decode import yolov8 as jd
from tpucv.decode.yolov8_seg import decode_seg as j_decode_seg
from tpucv.losses.yolov8_seg import yolov8_seg_loss as j_seg_loss
from tpucv.metrics.coco_map import COCOMaskAP as JMaskAP
from tpucv.models.yolov8 import Yolo8 as FlaxYolo8
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.data.coco import COCOIndex
from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex
from tpucv_torch.data.instance_seg_dataset import (InstanceSegDataset,
                                                   instance_seg_collate)
from tpucv_torch.decode import yolov8 as td
from tpucv_torch.decode.yolov8_seg import decode_seg
from tpucv_torch.losses.yolov8_seg import yolov8_seg_loss
from tpucv_torch.metrics.coco_map import COCOMaskAP
from tpucv_torch.models.yolov8 import Yolo8

torch.set_num_threads(1)
FWD_TOL = 5e-4
DEC_TOL = 1e-5
BOX_PX_TOL, BOX_RTOL = 1e-4, 1e-6
LOSS_REL = 1e-4
GRAD_TOL = 1e-5
STAT_TOL = 1e-12
REL_STEP1, REL_STEP2 = LOSS_REL, 1e-3
CLS_GAIN = 3000.0
SIZE = 160


@pytest.fixture(scope="module")
def weights():
    """tpucv's seg init with BatchNorm drawn from a seed, and the port's
    model loaded from it (strict)."""
    fm = FlaxYolo8(scale="n", nc=80, head="segment")
    v = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.default_rng(0)
    variables = {"params": randomize_bn(v["params"], rng),
                 "batch_stats": randomize_bn(v["batch_stats"], rng)}
    model = Yolo8("n", nc=80, head="segment")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return fm, variables, model.eval()


def test_forward_matches_flax(weights):
    fm, variables, model = weights
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3), dtype=np.float32)
    ref = jax.jit(fm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        det, coefs, protos = model(torch.from_numpy(x))
    got = [*det, *coefs, protos]
    want = [*ref[0], *ref[1], ref[2]]
    assert tuple(protos.shape) == (2, SIZE // 4, SIZE // 4, 32)
    assert tuple(coefs[0].shape) == (2, SIZE // 8, SIZE // 8, 32)
    for o, r in zip(got, want):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=FWD_TOL,
                                   rtol=0)


def test_parameters_and_keys(weights):
    _, variables, model = weights
    n = sum(np.size(x) for x in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n == sum(p.numel() for p in model.parameters()) == 4_063_984
    keys = model.state_dict().keys()
    for k in ("model.22.cv2.0.0.conv.weight", "model.22.cv3.2.2.bias",
              "model.22.cv4.1.2.weight", "model.22.proto.cv1.conv.weight",
              "model.22.proto.cv3.bn.running_var",
              "model.22.dfl.conv.weight"):
        assert k in keys, k
    assert model.model[22].cv4[0][0].conv.out_channels == 32    # max(64/4, 32)
    assert model.model[22].proto.cv2.conv.out_channels == 256


def test_classify_head_refused_by_name():
    """A head the port does not have is refused by name; "classify"
    (yolov8-cls) builds layers 0-8 and the classify head as layer 9."""
    with pytest.raises(ValueError, match="'obb'"):
        Yolo8("n", head="obb")
    model = Yolo8("n", head="classify")
    assert len(model.model) == 10
    assert type(model.model[9]).__name__ == "ClassifyHead"


def _raw(S, seed, B=2, nc=80, nm=32):
    rng = np.random.default_rng(seed)
    det, coefs = [], []
    for s in (8, 16, 32):
        m = rng.normal(0, 2.0, (B, S // s, S // s, 64 + nc))
        m[..., 64:] -= 1.0
        det.append(m.astype(np.float32))
        coefs.append(rng.normal(0, 1, (B, S // s, S // s, nm))
                     .astype(np.float32))
    protos = rng.normal(0, 1, (B, S // 4, S // 4, nm)).astype(np.float32)
    return det, coefs, protos


@pytest.mark.parametrize("S", [160, 256], ids=["nms_plain", "scan"])
def test_decode_seg_matches(S):
    det, coefs, protos = _raw(S, seed=S)
    jraw = ([jnp.asarray(m) for m in det], [jnp.asarray(m) for m in coefs],
            jnp.asarray(protos))
    traw = ([torch.from_numpy(m) for m in det],
            [torch.from_numpy(m) for m in coefs], torch.from_numpy(protos))
    ref = [np.asarray(x) for x in j_decode_seg(jraw)]
    got = [x.numpy() for x in decode_seg(traw)]
    _, _, _, valid, j_idx = jd.decode_boxes(jraw[0], return_idx=True)
    t_idx = td.decode_boxes(traw[0], return_idx=True)[4].numpy()
    v = ref[3]
    assert v.sum() > 20
    np.testing.assert_array_equal(got[3], v)
    np.testing.assert_array_equal(got[2][v], ref[2][v])
    np.testing.assert_array_equal(t_idx[v], np.asarray(j_idx)[v])
    np.testing.assert_allclose(got[0][v], ref[0][v], atol=BOX_PX_TOL,
                               rtol=BOX_RTOL)
    np.testing.assert_allclose(got[1][v], ref[1][v], atol=DEC_TOL, rtol=0)
    np.testing.assert_allclose(got[4][v], ref[4][v], atol=DEC_TOL, rtol=0)
    np.testing.assert_array_equal(got[5], ref[5])


def test_decode_boxes_detect_outputs_unchanged():
    """``return_idx`` adds a fifth output and leaves the four as they
    were."""
    det, _, _ = _raw(128, seed=3)
    maps = [torch.from_numpy(m) for m in det]
    plain = td.decode_boxes(maps)
    with_idx = td.decode_boxes(maps, return_idx=True)
    assert len(plain) == 4 and len(with_idx) == 5
    for a, b in zip(plain, with_idx):
        assert torch.equal(a, b)
    cands = td.topk_candidates(maps, pre_nms_topk=300)
    cands_idx = td.topk_candidates(maps, pre_nms_topk=300, return_idx=True)
    for a, b in zip(cands, cands_idx):
        assert torch.equal(a, b)


LOSS_CASES = {"few_fg": 3, "many_fg": 16, "padded": 8, "empty_image": 6}


def _loss_inputs(case, B=2, S=128, nc=80, nm=32):
    M = LOSS_CASES[case]
    det, coefs, protos = _raw(S, seed=list(LOSS_CASES).index(case) + 10,
                              B=B, nc=nc, nm=nm)
    rng = np.random.default_rng(list(LOSS_CASES).index(case))
    xy = rng.uniform(0, S * 0.6, (B, M, 2))
    wh = rng.uniform(12, S * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, nc, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    if case == "padded":
        mask[0, 5:] = False
        mask[1, 2:] = False
        boxes[~mask] = 0.0
    elif case == "empty_image":
        mask[1] = False
    Hm = S // 4
    inst = (rng.random((B, M, Hm, Hm)) < 0.3).astype(np.uint8)
    for b in range(B):
        for j in range(M):
            x1, y1, x2, y2 = (boxes[b, j] / 4).astype(int)
            inst[b, j, y1:y2 + 1, x1:x2 + 1] = 1
    return (det, coefs, protos), labels, boxes, mask, inst


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_seg_loss_value_terms_and_gradients(case):
    (det, coefs, protos), labels, boxes, mask, inst = _loss_inputs(case)

    def f(d, c, p):
        return j_seg_loss((d, c, p), jnp.asarray(labels), jnp.asarray(boxes),
                          jnp.asarray(mask), jnp.asarray(inst))

    (ref, ref_m), ref_g = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(
        [jnp.asarray(m) for m in det], [jnp.asarray(m) for m in coefs],
        jnp.asarray(protos))
    td_ = [torch.from_numpy(m).requires_grad_() for m in det]
    tc_ = [torch.from_numpy(m).requires_grad_() for m in coefs]
    tp_ = torch.from_numpy(protos).requires_grad_()
    got, got_m = yolov8_seg_loss(
        (td_, tc_, tp_), torch.from_numpy(labels), torch.from_numpy(boxes),
        torch.from_numpy(mask), torch.from_numpy(inst))
    got.backward()
    n_fg = float(ref_m["num_fg"])
    if case == "few_fg":
        assert 0 < n_fg < 2 * 64           # under mask_topk in each image
    if case == "many_fg":
        assert n_fg > 2 * 64
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_REL)
    for k in ("box_loss", "cls_loss", "dfl_loss", "mask_loss"):
        np.testing.assert_allclose(got_m[k].item(), float(ref_m[k]),
                                   rtol=LOSS_REL, atol=1e-7, err_msg=k)
    assert got_m["num_fg"].item() == n_fg
    assert got_m["mask_loss"].item() > 0
    for t, r in zip([*td_, *tc_, tp_], [*ref_g[0], *ref_g[1], ref_g[2]]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_TOL, rtol=0)


def _write_png(path, h, w, seed):
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    cv2.imwrite(str(path), img)


def _coco_fixture(root):
    """Three PNGs (one not square), polygons of several parts (one too
    short to fill), a box-only annotation and a crowd RLE."""
    images = [{"id": i + 1, "file_name": f"im{i}.png", "height": h,
               "width": w} for i, (h, w) in enumerate(
                   [(96, 128), (128, 128), (80, 100)])]
    anns = [
        {"id": 1, "image_id": 1, "category_id": 1, "iscrowd": 0,
         "bbox": [10, 12, 50, 40], "area": 1500.0,
         "segmentation": [[10, 12, 60, 12, 55, 52, 12, 40],
                          [70, 20, 90, 20, 80, 35]]},
        {"id": 2, "image_id": 1, "category_id": 3, "iscrowd": 0,
         "bbox": [60.5, 40.2, 30.3, 40.7], "area": 900.0,
         "segmentation": [[61, 41, 90, 41]]},          # too short
        {"id": 3, "image_id": 2, "category_id": 3, "iscrowd": 0,
         "bbox": [5.5, 6.5, 70.0, 60.25], "area": 3000.0},
        {"id": 4, "image_id": 2, "category_id": 1, "iscrowd": 1,
         "bbox": [0, 0, 20, 20], "area": 400.0,
         "segmentation": {"counts": [0, 400], "size": [128, 128]}},
        {"id": 5, "image_id": 3, "category_id": 1, "iscrowd": 0,
         "bbox": [20.3, 10.7, 40.1, 50.9], "area": 1200.0,
         "segmentation": [[20.3, 10.7, 60.4, 15.0, 40.0, 61.6]]},
    ]
    cats = [{"id": 1, "name": "a"}, {"id": 3, "name": "b"}]
    (root / "ann.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": cats}))
    for i, im in enumerate(images):
        _write_png(root / im["file_name"], im["height"], im["width"], i)
    return str(root / "ann.json"), str(root)


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("source", ["synthetic", "coco_polygons"])
def test_instance_seg_dataset_byte_equal(source, tmp_path):
    if source == "synthetic":
        j_idx, t_idx = JSynthIndex(4, 96, 80, seed=2), \
            SyntheticDetectionIndex(4, 96, 80, seed=2)
    else:
        ann, root = _coco_fixture(tmp_path)
        j_idx = JCOCOIndex(ann, root, keep_polys=True)
        t_idx = COCOIndex(ann, root, keep_polys=True)
    j_ds, t_ds = JSegDS(j_idx, 64, 4), InstanceSegDataset(t_idx, 64, 4)
    items = []
    for i in range(len(t_ds)):
        _assert_items_equal(t_ds[i], j_ds[i])
        items.append(t_ds[i])
    assert sum(int(it["gt_inst_masks"].sum()) for it in items) > 0
    batch = instance_seg_collate(items[:2])
    assert batch["gt_inst_masks"].shape == (2, 4, 16, 16)


def _mask_records(seed, n_img=3, n_cat=2, s=40):
    rng = np.random.default_rng(seed)
    gts, dts = [], []

    def rect():
        m = np.zeros((s, s), np.uint8)
        x, y = rng.integers(0, s - 8, 2)
        w, h = rng.integers(4, 20, 2)
        m[y:y + h, x:x + w] = 1
        return m

    for i in range(n_img):
        for _ in range(int(rng.integers(1, 5))):
            m = rect()
            gts.append({"image_id": i, "category_id": int(rng.integers(
                n_cat)), "mask": m, "area": float(m.sum()),
                "iscrowd": int(rng.random() < 0.2)})
        for _ in range(int(rng.integers(2, 8))):
            dts.append({"image_id": i, "category_id": int(rng.integers(
                n_cat)), "mask": rect() > 0, "score": float(rng.random())})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_mask_ap_same_stats(seed):
    gts, dts = _mask_records(seed)
    assert any(g["iscrowd"] for g in gts)
    ref = JMaskAP(gts, dts, [0, 1]).accumulate().summarize()
    got = COCOMaskAP(gts, dts, [0, 1]).accumulate().summarize()
    assert got.keys() == ref.keys() and len(got) == 12
    for k in ref:
        assert abs(got[k] - ref[k]) <= STAT_TOL, k
    # its own IoU keeps it off the bbox-only native core, as tpucv's
    assert COCOMaskAP(gts, dts, [0, 1])._accumulate_native() is False


def test_coco_mask_ap_crowd_is_an_ignore_region():
    m = np.zeros((20, 20), np.uint8)
    m[2:12, 2:12] = 1
    gts = [{"image_id": 0, "category_id": 0, "mask": m, "area": 100.0,
            "iscrowd": 1}]
    dts = [{"image_id": 0, "category_id": 0, "mask": m > 0, "score": 0.9}]
    stats = COCOMaskAP(gts, dts, [0]).accumulate().summarize()
    assert stats["AP"] == -1.0          # no GT counts: nothing to score


# ------------------------------------------------------ the slice as a whole
def _algos(size=SIZE, sharpen=True):
    jcfg, j_cls, _ = tpucv_export("yolo8_seg")
    tcfg, t_cls, _ = export_from_registry("yolo8_seg")
    for cfg in (jcfg, tcfg):
        cfg.train.mixed_precision = False
        cfg.dataset.input_size = size
    j, t = j_cls(jcfg), t_cls(tcfg, device="cpu")
    variables = j.init_variables()
    if sharpen:
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        for lv in range(3):
            head = params["segment"]["detect"][f"cv3_{lv}_2"]
            head["bias"] = np.zeros_like(head["bias"])
            head["kernel"] = head["kernel"] * CLS_GAIN
        variables = {"params": params,
                     "batch_stats": variables["batch_stats"]}
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
    assert got["masks"].dtype == bool and got["masks"].shape == \
        (len(ref["classes"]), SIZE, SIZE)
    np.testing.assert_array_equal(got["masks"], np.asarray(ref["masks"]))
    assert got["saved"].split("/")[-1].startswith("img_seg@")
    assert cv2.imread(got["saved"]).shape == (120, 160, 3)


def test_evaluate_mask_ap_equals_tpucv(pair, tmp_path):
    j, variables, t, model = pair
    ann, root = _coco_fixture(tmp_path)
    for j_idx, t_idx in ((JSynthIndex(5, 120, 80, seed=4),
                          SyntheticDetectionIndex(5, 120, 80, seed=4)),
                         (JCOCOIndex(ann, root, keep_polys=True),
                          COCOIndex(ann, root, keep_polys=True))):
        ref = j.evaluate_mask_ap(variables, j_idx, batch_size=2,
                                 verbose=False)
        got = t.evaluate_mask_ap(model, t_idx, batch_size=2, verbose=False)
        assert got.keys() == ref.keys() and len(got) == 12
        for k in ref:
            assert abs(got[k] - ref[k]) <= STAT_TOL, k


def _shrink(cfg, root):
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = 2
    cfg.train.mixed_precision = False
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.loss.mask_topk = 8
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    return cfg


def test_trainer_steps_equal_tpucv(tmp_path):
    """Both trainers on one tiny config (synthetic data, no device
    augmentation in either), tpucv's init weights in both, 2 steps."""
    jcfg, _, j_cls = tpucv_export("yolo8_seg")
    j = j_cls(_shrink(jcfg, tmp_path / "tpucv"))
    tcfg, _, t_cls = export_from_registry("yolo8_seg")
    t = t_cls(_shrink(tcfg, tmp_path / "port"), device="cpu")
    t.model.load_state_dict(from_flax_variables(
        {"params": j.init_params, "batch_stats": j.init_batch_stats}))
    j.tb, t.tb = Recorder(), Recorder()
    j.train(max_steps=2)
    t.train(max_steps=2)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "mask_loss"):
        for step, rel in ((1, REL_STEP1), (2, REL_STEP2)):
            np.testing.assert_allclose(
                t.tb.rows[f"train/{k}"][step], j.tb.rows[f"train/{k}"][step],
                rtol=rel, err_msg=f"{k} step {step}")
    assert t.tb.rows["train/num_fg"][1] == j.tb.rows["train/num_fg"][1]


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """The CLIs' registry lookup at input 160, f32; runs in tmp_path."""
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
    return train, predict, evaluate


def test_clis_on_the_cpu(small_cli, tmp_path, monkeypatch, capsys):
    train, predict, evaluate = small_cli
    train.main(["--model", "yolo8_seg", "--device", "cpu", "--max-steps",
                "1", "--batch-size", "2"])
    ckpt = tmp_path / "saves" / "yolo8_seg_coco_final.ckpt"
    assert ckpt.is_file()
    src = str(tmp_path / "a.png")
    _write_png(src, 100, 150, 9)
    out = predict.main(["--model", "yolo8_seg", "--device", "cpu", "--ckpt",
                        str(ckpt), "--src", src, "--dst", "drawn"])
    assert "masks" in out[0] and out[0]["saved"]
    assert "a.png: " in capsys.readouterr().out
    coco = tmp_path / "coco"
    (coco / "annotations").mkdir(parents=True)
    (coco / "val2017").mkdir()
    ann, _ = _coco_fixture(coco / "val2017")
    (coco / "val2017" / "ann.json").rename(
        coco / "annotations" / "instances_val2017.json")
    monkeypatch.setenv("TPUCV_COCO_ROOT", str(coco))
    stats = evaluate.main(["--model", "yolo8_seg", "--device", "cpu",
                           "--batch-size", "2", "--ckpt", str(ckpt)])
    assert len(stats) == 12 and (tmp_path / "result" /
                                 "eval_results.json").is_file()
