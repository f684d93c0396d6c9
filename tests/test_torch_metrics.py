"""The port's metric engines (``tpucv_torch/metrics/``) against tpucv's, on
the CPU, on seeded random GTs and detections over a few images and
classes, with difficult (VOC) and crowd (COCO) GTs among them and score
ties: ``evaluate_voc_map`` (per-class AP, counts, precision / recall
curves, lamr, mAP; with and without the +1 pixel convention, at IoU 0.5
and 0.75), ``log_average_miss_rate`` and ``COCOMeanAP``'s numpy engine
(``accumulate(use_native=False)``; precision / recall arrays and the 12
``summarize`` stats). Both sides are numpy in f64 and run the same
arithmetic, so everything is held within 1e-12.
"""

import numpy as np
import pytest
import torch

from tpucv.metrics import coco_map as j_coco
from tpucv.metrics import voc_map as j_voc
from tpucv_torch.metrics import coco_map as t_coco
from tpucv_torch.metrics import voc_map as t_voc

torch.set_num_threads(1)
ATOL = 1e-12
CLASSES = ["a", "b", "c", "d"]


def _voc_case(seed, n_img=5, n_gt=25, n_dt=70):
    """GTs (a fifth difficult) and detections jittered around them or
    placed at random; scores rounded to 0.05 so ties occur."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(n_gt):
        x, y = rng.uniform(0, 300, 2)
        w, h = rng.uniform(8, 150, 2)
        gts.append({"image_id": int(rng.integers(n_img)),
                    "class_id": int(rng.integers(len(CLASSES))),
                    "bbox": [x, y, x + w, y + h],
                    "difficult": bool(rng.random() < 0.2)})
    for _ in range(n_dt):
        if rng.random() < 0.6:
            g = gts[int(rng.integers(n_gt))]
            b = (np.asarray(g["bbox"]) + rng.normal(0, 6, 4)).tolist()
            img, cls = g["image_id"], g["class_id"]
        else:
            x, y = rng.uniform(0, 300, 2)
            w, h = rng.uniform(8, 150, 2)
            b = [x, y, x + w, y + h]
            img = int(rng.integers(n_img))
            cls = int(rng.integers(len(CLASSES)))
        dts.append({"image_id": img, "class_id": cls, "bbox": b,
                    "score": round(float(rng.random()) * 20) / 20})
    return gts, dts


def _coco_case(seed):
    """The VOC case in COCO form: xywh boxes, difficult as crowd."""
    gts, dts = _voc_case(seed)
    cg = [{"image_id": g["image_id"], "category_id": g["class_id"] + 1,
           "bbox": [g["bbox"][0], g["bbox"][1], g["bbox"][2] - g["bbox"][0],
                    g["bbox"][3] - g["bbox"][1]],
           "area": (g["bbox"][2] - g["bbox"][0]) * (g["bbox"][3] - g["bbox"][1]),
           "iscrowd": int(g["difficult"])} for g in gts]
    cd = [{"image_id": d["image_id"], "category_id": d["class_id"] + 1,
           "bbox": [d["bbox"][0], d["bbox"][1], d["bbox"][2] - d["bbox"][0],
                    d["bbox"][3] - d["bbox"][1]], "score": d["score"]}
          for d in dts]
    return cg, cd, [1, 2, 3, 4]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("iou,onepix", [(0.5, True), (0.5, False),
                                        (0.75, True)])
def test_evaluate_voc_map_equals_tpucv(seed, iou, onepix):
    gts, dts = _voc_case(seed)
    ref = j_voc.evaluate_voc_map(gts, dts, CLASSES, iou, onepix)
    got = t_voc.evaluate_voc_map(gts, dts, CLASSES, iou, onepix)
    assert abs(got["mAP"] - ref["mAP"]) <= ATOL
    assert got["iou_threshold"] == ref["iou_threshold"]
    assert got["per_class"].keys() == ref["per_class"].keys()
    for name, r in ref["per_class"].items():
        g = got["per_class"][name]
        assert (g["n_gt"], g["n_det"]) == (r["n_gt"], r["n_det"])
        assert abs(g["AP"] - r["AP"]) <= ATOL
        assert abs(g["lamr"] - r["lamr"]) <= ATOL
        np.testing.assert_allclose(g["precision"], r["precision"], atol=ATOL)
        np.testing.assert_allclose(g["recall"], r["recall"], atol=ATOL)
    # the case exercises what it claims: difficult GTs and some misses
    assert any(g["difficult"] for g in gts)
    assert 0.0 < ref["mAP"] < 1.0


@pytest.mark.parametrize("seed", range(3))
def test_log_average_miss_rate_equals_tpucv(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    prec = rng.random(n)
    fp = np.cumsum(rng.random(n) < 0.5)
    for n_img in (0, 1, 7):
        ref = j_voc.log_average_miss_rate(prec, fp, n_img)
        got = t_voc.log_average_miss_rate(prec, fp, n_img)
        assert abs(got[0] - ref[0]) <= ATOL
        np.testing.assert_allclose(got[1], ref[1], atol=ATOL)
        np.testing.assert_allclose(got[2], ref[2], atol=ATOL)
    assert t_voc.log_average_miss_rate(np.zeros(0), np.zeros(0), 3) == \
        j_voc.log_average_miss_rate(np.zeros(0), np.zeros(0), 3)


def test_voc_ap_equals_tpucv():
    rng = np.random.default_rng(0)
    for n in (0, 1, 5, 50):
        rec = np.sort(rng.random(n))
        prec = rng.random(n)
        assert abs(t_voc.voc_ap(rec, prec) - j_voc.voc_ap(rec, prec)) <= ATOL


@pytest.mark.parametrize("seed", range(4))
def test_coco_numpy_engine_and_summary_equal_tpucv(seed):
    gts, dts, cats = _coco_case(seed)
    ref = j_coco.COCOMeanAP(gts, dts, cats).accumulate(use_native=False)
    got = t_coco.COCOMeanAP(gts, dts, cats).accumulate(use_native=False)
    np.testing.assert_allclose(got.precision, ref.precision, atol=ATOL)
    np.testing.assert_allclose(got.recall, ref.recall, atol=ATOL)
    rs, gs = ref.summarize(), got.summarize()
    assert list(gs) == list(rs) and len(gs) == 12
    for k in rs:
        assert abs(gs[k] - rs[k]) <= ATOL, k
    assert any(g["iscrowd"] for g in gts)
    assert 0.0 < rs["AP50"] < 1.0


def test_iou_xywh_equals_tpucv():
    rng = np.random.default_rng(1)
    d = rng.uniform(1, 50, (7, 4))
    g = rng.uniform(1, 50, (5, 4))
    crowd = np.array([0, 1, 0, 1, 0], bool)
    np.testing.assert_array_equal(t_coco._iou_xywh(d, g, crowd),
                                  j_coco._iou_xywh(d, g, crowd))
    assert t_coco._iou_xywh(d[:0], g, crowd).shape == (0, 5)


def test_print_summaries_equal_tpucv(capsys):
    gts, dts, cats = _coco_case(0)
    stats = t_coco.COCOMeanAP(gts, dts, cats).accumulate(False).summarize()
    res = t_voc.evaluate_voc_map(*_voc_case(0), CLASSES)
    printed = []
    for coco, voc in ((t_coco, t_voc), (j_coco, j_voc)):
        coco.COCOMeanAP(gts, dts, cats).print_summary(stats)
        voc.print_voc_map(res)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert len(printed[0].splitlines()) == 12 + len(CLASSES) + 1
