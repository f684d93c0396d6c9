"""The evaluation harness: the port's ``evaluate_on_coco`` /
``evaluate_on_voc`` / ``build_eval_index`` against tpucv's, on the CPU.

- A stubbed detection stream (``_batched_detections`` replaced on both
  algorithms) over a COCO index with a crowd GT and a VOC index with a
  difficult object, as ``tests/test_eval_ignore.py`` builds them: the
  crowd / difficult overlap is an ignore region (AP 1.0), and seeded random
  streams over the same indices give both packages the same stats (the
  12 COCO stats, the VOC per-class AP and mAP and the COCO cross-summary;
  within 1e-12: both are numpy in f64 on identical detections).
- End to end on a 6-image COCO root from ``scripts/make_synthetic_coco.py``
  (640x480 JPEGs, crowd GTs among the annotations), f32, the same weights
  (tpucv's init with the class biases zeroed and the class kernels scaled
  by ``CLS_GAIN``, as ``tests/test_torch_serving.py`` does, carried across
  with ``from_flax_variables``), at conf 0.001 (the evaluate CLI's), at
  input 160 and 256. The anchor count picks the NMS engine: 525 anchors
  at 160, so K <= 1024 and the kernel's plain version runs (tpucv: its
  XLA fixpoint); 1,344 at 256, so K > 1024 and both run the sequential
  scan. Per image the detections must be equal: classes exactly, boxes
  within 1e-3 px, scores within 1e-5; and the 12 stats within 1e-6, both
  against the root's GTs (which random weights do not hit: every stat 0)
  and against GTs made from tpucv's best detections (AP 0.90-0.98; the
  small / medium buckets stay empty, -1).
- ``build_eval_index`` for a COCO root (``TPUCV_COCO_ROOT``) and a VOC
  root (``TPUCV_VOC_ROOT``): the same samples as tpucv's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv.data.coco import COCOIndex as JCOCOIndex
from tpucv.data.voc import VOCDetectionIndex as JVOCIndex
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.configs.dataset_cfg import VOC_CLASSES
from tpucv_torch.data.coco import COCOIndex
from tpucv_torch.data.voc import VOCDetectionIndex

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CLS_GAIN = 3000.0
BOX_TOL, SCORE_TOL, STAT_TOL = 1e-3, 1e-5, 1e-6


def _algos(input_size=640):
    jcfg, j_cls, _ = tpucv_export("yolo8_det")
    tcfg, t_cls, _ = export_from_registry("yolo8_det")
    for cfg in (jcfg, tcfg):
        cfg.train.mixed_precision = False
        cfg.dataset.input_size = input_size
    return j_cls(jcfg), t_cls(tcfg, device="cpu")


# ------------------------------------------------------------ stubbed
def _write_coco(tmp_path, n_images):
    """Image 7: a GT and a crowd GT of category 1 (tests/test_eval_ignore.py);
    image 9 (when ``n_images`` is 2): two GTs of both categories."""
    js = {
        "images": [{"id": 7, "file_name": "000000000007.jpg",
                    "height": 480, "width": 640},
                   {"id": 9, "file_name": "000000000009.jpg",
                    "height": 480, "width": 640}],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 1,
             "bbox": [10.0, 10.0, 30.0, 30.0], "area": 900.0, "iscrowd": 0},
            {"id": 2, "image_id": 7, "category_id": 1,
             "bbox": [100.0, 100.0, 100.0, 100.0], "area": 10000.0,
             "iscrowd": 1},
            {"id": 3, "image_id": 9, "category_id": 2,
             "bbox": [200.0, 50.0, 120.0, 80.0], "area": 9600.0,
             "iscrowd": 0},
            {"id": 4, "image_id": 9, "category_id": 1,
             "bbox": [20.0, 300.0, 60.0, 90.0], "area": 5400.0,
             "iscrowd": 0},
        ],
        "categories": [{"id": 1, "name": "person"},
                       {"id": 2, "name": "bicycle"}],
    }
    js["images"] = js["images"][:n_images]
    js["annotations"] = [a for a in js["annotations"]
                         if a["image_id"] in {im["id"] for im in js["images"]}]
    p = tmp_path / "instances.json"
    p.write_text(json.dumps(js))
    return str(p)


def _write_voc(tmp_path, n_images=2):
    """img0: an aeroplane and a difficult one (tests/test_eval_ignore.py);
    img1 (when ``n_images`` is 2): a dog, a person and a difficult person."""
    ann = tmp_path / "Annotations"
    sets = tmp_path / "ImageSets" / "Main"
    ann.mkdir(parents=True)
    sets.mkdir(parents=True)
    (sets / "val.txt").write_text("".join(f"img{i}\n"
                                          for i in range(n_images)))

    def obj(name, box, difficult):
        return (f"<object><name>{name}</name><difficult>{difficult}"
                f"</difficult><bndbox><xmin>{box[0]}</xmin><ymin>{box[1]}"
                f"</ymin><xmax>{box[2]}</xmax><ymax>{box[3]}</ymax>"
                f"</bndbox></object>")

    (ann / "img0.xml").write_text(
        "<annotation>" + obj("aeroplane", (10, 10, 40, 40), 0)
        + obj("aeroplane", (100, 100, 200, 200), 1) + "</annotation>")
    (ann / "img1.xml").write_text(
        "<annotation>" + obj("dog", (50, 60, 250, 220), 0)
        + obj("person", (300, 20, 360, 200), 0)
        + obj("person", (400, 30, 430, 90), 1) + "</annotation>")
    return str(tmp_path)


def _stub(stream):
    def fake(variables, index, batch_size, conf_threshold):
        yield from stream
    return fake


def _fixed_coco_stream():
    # the crowd-overlapping detection scores above the true one: counted as
    # a false positive it would halve AP
    return [(0, np.array([[120.0, 120.0, 180.0, 180.0],
                          [10.0, 10.0, 40.0, 40.0]], np.float32),
             np.array([0.9, 0.8], np.float32), np.array([0, 0], np.int32))]


def _fixed_voc_stream():
    cid = VOC_CLASSES.index("aeroplane")
    return [(0, np.array([[100.0, 100.0, 200.0, 200.0],
                          [10.0, 10.0, 40.0, 40.0]], np.float32),
             np.array([0.9, 0.8], np.float32),
             np.array([cid, cid], np.int32))]


def _random_stream(seed, n_images, classes):
    """Per image 12 boxes: half jittered copies of fixed anchors, half at
    random; scores rounded to 0.05 (ties)."""
    rng = np.random.default_rng(seed)
    anchors = np.array([[10, 10, 40, 40], [120, 120, 180, 180],
                        [200, 50, 320, 130], [20, 300, 80, 390],
                        [50, 60, 250, 220], [300, 20, 360, 200]], np.float32)
    out = []
    for i in range(n_images):
        near = anchors[rng.integers(0, len(anchors), 6)] + \
            rng.normal(0, 5, (6, 4)).astype(np.float32)
        xy = rng.uniform(0, 400, (6, 2))
        far = np.concatenate([xy, xy + rng.uniform(10, 150, (6, 2))], 1)
        boxes = np.concatenate([near, far]).astype(np.float32)
        scores = (np.round(rng.random(12) * 20) / 20).astype(np.float32)
        cls = np.asarray(classes, np.int32)[rng.integers(0, len(classes), 12)]
        out.append((i, boxes, scores, cls))
    return out


@pytest.mark.parametrize("stream", ["fixed", 0, 1, 2])
def test_coco_stubbed_stream_same_stats(tmp_path, stream):
    ann = _write_coco(tmp_path, 1 if stream == "fixed" else 2)
    j, t = _algos()
    dets = _fixed_coco_stream() if stream == "fixed" else \
        _random_stream(stream, 2, [0, 1])
    j._batched_detections = _stub(dets)
    t._batched_detections = _stub(dets)
    ref = j.evaluate_on_coco(None, JCOCOIndex(ann, str(tmp_path)),
                             result_dir=str(tmp_path / "j"), verbose=False)
    got = t.evaluate_on_coco(None, COCOIndex(ann, str(tmp_path)),
                             result_dir=str(tmp_path / "t"), verbose=False)
    assert list(got) == list(ref) and len(got) == 12
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, k
    assert json.loads((tmp_path / "t" / "eval_results.json").read_text()) \
        == json.loads((tmp_path / "j" / "eval_results.json").read_text())
    if stream == "fixed":
        assert got["AP"] == pytest.approx(1.0)     # the crowd is ignored


@pytest.mark.parametrize("stream", ["fixed", 0, 1, 2])
def test_voc_stubbed_stream_same_stats(tmp_path, stream):
    root = _write_voc(tmp_path, 1 if stream == "fixed" else 2)
    j, t = _algos()
    j.class_names = t.class_names = list(VOC_CLASSES)
    classes = [VOC_CLASSES.index(c) for c in ("aeroplane", "dog", "person")]
    dets = _fixed_voc_stream() if stream == "fixed" else \
        _random_stream(stream, 2, classes)
    j._batched_detections = _stub(dets)
    t._batched_detections = _stub(dets)
    ref = j.evaluate_on_voc(None, JVOCIndex(root, "val"), verbose=False)
    got = t.evaluate_on_voc(None, VOCDetectionIndex(root, "val"),
                            verbose=False)
    assert abs(got["mAP"] - ref["mAP"]) <= 1e-12
    for name, r in ref["per_class"].items():
        g = got["per_class"][name]
        assert (g["n_gt"], g["n_det"]) == (r["n_gt"], r["n_det"]), name
        assert abs(g["AP"] - r["AP"]) <= 1e-12, name
    assert list(got["coco"]) == list(ref["coco"]) and len(got["coco"]) == 12
    for k in ref["coco"]:
        assert abs(got["coco"][k] - ref["coco"][k]) <= 1e-12, k
    if stream == "fixed":
        assert got["per_class"]["aeroplane"]["n_gt"] == 1
        assert got["mAP"] == pytest.approx(1.0)
        assert got["coco"]["AP"] == pytest.approx(1.0)


# ------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("syncoco")
    subprocess.run([sys.executable, "scripts/make_synthetic_coco.py",
                    "--root", str(root), "--n", "6"], check=True, cwd=ROOT)
    return root


@pytest.fixture(scope="module")
def weights():
    """tpucv's init with a sharpened class branch: the init's logits are
    ~1e-4, so every score would sit within an f32 ulp of 0.5."""
    j, _ = _algos(160)
    variables = j.init_variables()
    params = {k: dict(v) for k, v in variables["params"].items()}
    for lv in range(3):
        head = dict(params["detect"][f"cv3_{lv}_2"])
        head["bias"] = np.zeros_like(head["bias"])
        head["kernel"] = np.asarray(head["kernel"]) * CLS_GAIN
        params["detect"][f"cv3_{lv}_2"] = head
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _recorded(algo):
    """Wrap ``algo._batched_detections`` so each image's detections are
    kept as they are yielded."""
    orig, seen = algo._batched_detections, []

    def wrapper(*args, **kw):
        for item in orig(*args, **kw):
            seen.append(item)
            yield item

    algo._batched_detections = wrapper
    return seen


def _pseudo_gt(ann, seen, path):
    """The annotation file with its GTs replaced by each image's 8 best
    detections (rounded to whole pixels; the 8th a crowd): random weights
    match no synthetic GT, so against the real GTs every stat is 0."""
    js = json.loads(Path(ann).read_text())
    cats = sorted(c["id"] for c in js["categories"])
    anns = []
    for (i, boxes, scores, classes), im in zip(seen, js["images"]):
        for k, j in enumerate(np.argsort(-scores, kind="stable")[:8]):
            x1, y1, x2, y2 = np.round(boxes[j]).tolist()
            anns.append({"id": len(anns) + 1, "image_id": im["id"],
                         "category_id": cats[int(classes[j])],
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1), "iscrowd": int(k == 7)})
    js["annotations"] = anns
    path.write_text(json.dumps(js))
    return str(path)


@pytest.mark.parametrize("size,engine", [(160, "kernel's plain version"),
                                         (256, "scan")])
def test_end_to_end_coco_equals_tpucv(coco_root, weights, tmp_path, size,
                                      engine):
    j, t = _algos(size)
    model = t.init_variables()
    model.load_state_dict(from_flax_variables(weights), strict=True)
    ann = str(coco_root / "annotations" / "instances_val2017.json")
    img_dir = str(coco_root / "val2017")
    j_seen, t_seen = _recorded(j), _recorded(t)

    def both(ann_file):
        return [algo.evaluate_on_coco(
            m, index_cls(ann_file, img_dir), batch_size=3,
            result_dir=str(tmp_path / name), verbose=False)
            for algo, m, index_cls, name in ((j, weights, JCOCOIndex, "j"),
                                             (t, model, COCOIndex, "t"))]

    ref, got = both(ann)
    assert [s[0] for s in t_seen] == [s[0] for s in j_seen] == list(range(6))
    n_anchors = sum((size // s) ** 2 for s in (8, 16, 32))
    assert (n_anchors > 1024) == (engine == "scan")
    for (_, jb, js, jc), (_, tb, ts, tc) in zip(j_seen, t_seen):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tb, jb, atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(ts, js, atol=SCORE_TOL, rtol=0)
    # the NMS had work: at 160 it suppressed (fewer than max_det kept of
    # 525 candidates), at 256 it filled max_det
    assert all(0 < len(s[3]) <= 300 for s in t_seen)
    assert os.path.isfile(tmp_path / "t" / "eval_results.json")
    # against GTs that the detections hit, so the stats are not all 0
    pseudo_ref, pseudo_got = both(_pseudo_gt(ann, j_seen[:6],
                                             tmp_path / "pseudo.json"))
    assert pseudo_ref["AP50"] > 0.1
    for r, g in ((ref, got), (pseudo_ref, pseudo_got)):
        assert list(g) == list(r) and len(g) == 12
        for k in r:
            assert abs(g[k] - r[k]) <= STAT_TOL, (k, g[k], r[k])


# ---------------------------------------------------------- eval index
def test_build_eval_index_coco_and_voc(coco_root, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUCV_COCO_ROOT", str(coco_root))
    monkeypatch.setenv("TPUCV_VOC_ROOT", _write_voc(tmp_path))
    for name in ("coco", "voc"):
        j, t = _algos()
        j.cfg.dataset.name = t.cfg.dataset.name = name
        ji, ti = j.build_eval_index("val"), t.build_eval_index("val")
        assert type(ti).__name__ == type(ji).__name__
        assert len(ti) == len(ji) == (6 if name == "coco" else 2)
        for i in range(len(ji)):
            a, b = ji[i], ti[i]
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
        if name == "coco":
            assert ti.image_id(0) == ji.image_id(0)
            assert [ti.eval_gt_records(i) for i in range(6)] == \
                [ji.eval_gt_records(i) for i in range(6)]
            assert any(r["iscrowd"] for i in range(6)
                       for r in ti.eval_gt_records(i))
        else:
            for i in range(2):
                for a, b in zip(ji.eval_record(i), ti.eval_record(i)):
                    np.testing.assert_array_equal(a, b)
