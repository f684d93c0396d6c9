"""The port's host data pipeline against tpucv's, on the CPU.

``tpucv_torch.data`` is a copy of ``tpucv.data`` (numpy and cv2 only), so
everything here is held exactly: the synthetic index's records, the
dataset's samples byte for byte (train with and without mosaic, with and
without device augmentation, eval), the loader's batches in both engines,
and the COCO / VOC indices over a tiny on-disk fixture. Images in the
fixture are PNG, so no test starts tpucv's native JPEG build.
"""

import json
import os
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest
import torch

from tpucv.data import coco as j_coco
from tpucv.data import detection_dataset as j_dd
from tpucv.data import loader as j_loader
from tpucv.data import transforms as j_tf
from tpucv.data import voc as j_voc
from tpucv_torch.data import coco as t_coco
from tpucv_torch.data import detection_dataset as t_dd
from tpucv_torch.data import loader as t_loader
from tpucv_torch.data import transforms as t_tf
from tpucv_torch.data import voc as t_voc

torch.set_num_threads(1)


def assert_same(a, b, path="sample"):
    """Equal structure, dtypes and bytes."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("n,size,nc,seed", [(6, 64, 20, 0), (5, 96, 80, 3),
                                            (4, 80, 1, 1)])
def test_synthetic_index_records_equal(n, size, nc, seed):
    j = j_dd.SyntheticDetectionIndex(n, size, nc, seed=seed)
    t = t_dd.SyntheticDetectionIndex(n, size, nc, seed=seed)
    assert len(j) == len(t) == n
    for i in range(n):
        assert_same(j[i], t[i], f"record {i}")


def test_hsv_jitter_byte_equal():
    img = np.random.default_rng(0).integers(0, 256, (48, 40, 3), np.uint8)
    for seed in range(4):
        a = j_dd.hsv_jitter(img, np.random.default_rng(seed))
        b = t_dd.hsv_jitter(img, np.random.default_rng(seed))
        assert_same(a, b, f"seed {seed}")


DATASET_CASES = {
    # name: (train, mosaic_prob, device_aug)
    "train_mosaic": (True, 1.0, False),
    "train_no_mosaic": (True, 0.0, False),
    "train_mixed_device_aug": (True, 0.5, True),
    "train_no_mosaic_device_aug": (True, 0.0, True),
    "eval": (False, 0.5, False),
}


def _datasets(case, n=12, image_size=80, input_size=64, max_boxes=5, seed=4):
    train, mosaic, dev_aug = DATASET_CASES[case]
    out = []
    for mod in (j_dd, t_dd):
        idx = mod.SyntheticDetectionIndex(n, image_size, 20, seed=seed)
        out.append(mod.DetectionDataset(
            idx, input_size, max_boxes, train=train, mosaic_prob=mosaic,
            epochs=10, seed=seed, device_aug=dev_aug))
    return out


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_samples_byte_equal(case):
    """The same sequence of samples from the same seed: each draw moves
    the dataset's generator, so the order of calls is held too."""
    j, t = _datasets(case)
    for i in [0, 3, 7, 11, 5, 0]:
        assert_same(j[i], t[i], f"{case} item {i}")


def test_dataset_mosaic_gate_follows_epoch():
    """Past ``epochs * special_aug_ratio`` mosaic stops, on both sides."""
    j, t = _datasets("train_mixed_device_aug")
    for ds in (j, t):
        ds.set_epoch(9)                     # 9 >= 10 * 0.7
    flags = []
    for i in range(12):
        a, b = j[i], t[i]
        assert_same(a, b, f"item {i}")
        flags.append(a[3])
    assert not any(flags)


def _collect(loader, n=None):
    out = []
    for i, b in enumerate(loader):
        out.append({k: v.copy() for k, v in b.items()})
        if n is not None and i + 1 >= n:
            break
    return out


def _loaders(num_workers=0, n=13, batch_size=4, drop_last=True,
             device_aug=True, seed=7):
    out = []
    for mod, lmod in ((j_dd, j_loader), (t_dd, t_loader)):
        ds = mod.DetectionDataset(
            mod.SyntheticDetectionIndex(n, 64, 20, seed=3), 64, 6,
            train=True, mosaic_prob=0.5, seed=3, device_aug=device_aug)
        out.append(lmod.Loader(ds, batch_size, shuffle=True, seed=seed,
                               drop_last=drop_last,
                               num_workers=num_workers if lmod is t_loader
                               else 0))
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal(num_workers):
    """The port's thread engine and its forked shared-memory engine give
    tpucv's thread-engine batches, in order."""
    j, t = _loaders(num_workers)
    ref, got = _collect(j), _collect(t)
    assert len(ref) == len(got) == len(t) == 3
    assert_same(ref, got, "batches")
    flags = np.concatenate([b["host_aug"] for b in got])
    assert flags.any() and not flags.all()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_ragged_last_batch(num_workers):
    j, t = _loaders(num_workers, n=10, drop_last=False)
    ref, got = _collect(j), _collect(t)
    assert [b["images"].shape[0] for b in got] == [4, 4, 2]
    assert_same(ref, got, "batches")


def test_loader_set_epoch_reshuffles():
    j, t = _loaders(2, n=16)
    e0 = _collect(t)
    j.set_epoch(1)
    t.set_epoch(1)
    e1 = _collect(t)
    assert_same(_collect(j), e1, "epoch 1")
    assert not np.array_equal(e0[0]["images"], e1[0]["images"])
    t.set_epoch(0)
    assert_same(e0, _collect(t), "epoch 0 again")


def test_loader_early_break_cleans_up():
    """An abandoned iterator stops its workers and frees its shared
    memory; the next pass starts afresh and gives the whole epoch."""
    _, t = _loaders(2, n=32)
    _collect(t, n=2)
    for _ in range(2):
        _collect(t, n=1)
    full = _collect(t)
    assert len(full) == 8
    j, _ = _loaders(0, n=32)
    assert_same(_collect(j), full, "after early breaks")


def test_collates_equal():
    rng = np.random.default_rng(0)
    samples = [(rng.integers(0, 256, (8, 8, 3), np.uint8),
                rng.random((3, 5)).astype(np.float32),
                rng.random(3) < 0.5) for _ in range(3)]
    assert_same(j_loader.detection_collate(samples),
                t_loader.detection_collate(samples), "detection")
    aug = [s + (bool(k % 2),) for k, s in enumerate(samples)]
    assert_same(j_loader.detection_collate(aug),
                t_loader.detection_collate(aug), "detection + host_aug")
    seg = [(s[0], s[0][..., 0], None) for s in samples]
    assert_same(j_loader.segmentation_collate(seg),
                t_loader.segmentation_collate(seg), "segmentation")


# ------------------------------------------------------------- fixtures --
def _write_png(path, seed, h, w):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    assert cv2.imwrite(str(path), img)


@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    """Three PNG images; annotations with crowd, degenerate and ordinary
    boxes over three categories with gapped ids."""
    root = tmp_path_factory.mktemp("coco")
    images, anns = [], []
    sizes = [(60, 80), (72, 50), (64, 64)]
    for k, (h, w) in enumerate(sizes):
        name = f"{k:04d}.png"
        _write_png(root / name, k, h, w)
        images.append({"id": 100 + k, "file_name": name, "height": h,
                       "width": w})
    boxes = [(100, [5, 6, 20, 30], 3, 0), (100, [40, 10, 30, 40], 18, 0),
             (100, [1, 1, 0.0005, 8], 3, 0), (101, [2, 3, 40, 50], 1, 0),
             (101, [0, 0, 50, 72], 18, 1), (102, [10, 10, 10, 10], 1, 0)]
    for a, (img_id, bbox, cat, crowd) in enumerate(boxes):
        anns.append({"id": a + 1, "image_id": img_id, "bbox": bbox,
                     "category_id": cat, "iscrowd": crowd,
                     "area": bbox[2] * bbox[3] * 0.9})
    cats = [{"id": 18, "name": "dog"}, {"id": 1, "name": "person"},
            {"id": 3, "name": "car"}]
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns,
                                    "categories": cats}))
    return str(ann_file), str(root)


def test_coco_index_equal(coco_fixture):
    ann, root = coco_fixture
    j, t = j_coco.COCOIndex(ann, root), t_coco.COCOIndex(ann, root)
    assert j.cat_ids == t.cat_ids == [1, 3, 18]
    assert j.cat_to_contig == t.cat_to_contig
    assert j.contig_to_cat == t.contig_to_cat
    assert j.cat_names == t.cat_names
    assert len(j) == len(t) == 3
    for i in range(3):
        assert_same(j[i], t[i], f"sample {i}")
        assert j.image_id(i) == t.image_id(i)
        assert j.eval_gt_records(i) == t.eval_gt_records(i)
    assert any(r["iscrowd"] for i in range(3) for r in t.eval_gt_records(i))


def test_coco_dataset_samples_equal(coco_fixture):
    """Samples read from the PNG files through both datasets."""
    ann, root = coco_fixture
    for train in (False, True):
        j = j_dd.DetectionDataset(j_coco.COCOIndex(ann, root), 64, 4,
                                  train=train, mosaic_prob=0.5, seed=2)
        t = t_dd.DetectionDataset(t_coco.COCOIndex(ann, root), 64, 4,
                                  train=train, mosaic_prob=0.5, seed=2)
        for i in (0, 1, 2, 1):
            assert_same(j[i], t[i], f"train={train} item {i}")


@pytest.fixture(scope="module")
def voc_fixture(tmp_path_factory):
    """A VOCdevkit split of two annotation files: difficult flags written
    plainly and pretty-printed, an unknown class, and an empty image."""
    root = tmp_path_factory.mktemp("voc")
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Main").mkdir(parents=True)
    objs = {
        "a1": [("dog", (10, 20, 50, 60), "0"), ("person", (1, 2, 3, 4), "1"),
               ("unicorn", (5, 5, 9, 9), "0"),
               ("tvmonitor", (7.5, 8.5, 30, 40), "\n1\n")],
        "b2": [],
    }
    for img_id, items in objs.items():
        ann = ET.Element("annotation")
        for name, box, diff in items:
            o = ET.SubElement(ann, "object")
            ET.SubElement(o, "name").text = name
            ET.SubElement(o, "difficult").text = diff
            bb = ET.SubElement(o, "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
                ET.SubElement(bb, k).text = str(v)
        ET.ElementTree(ann).write(root / "Annotations" / f"{img_id}.xml")
    (root / "ImageSets" / "Main" / "train.txt").write_text("a1\nb2\n")
    return str(root)


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_voc_index_equal(voc_fixture, keep_difficult):
    j = j_voc.VOCDetectionIndex(voc_fixture, "train",
                                keep_difficult=keep_difficult)
    t = t_voc.VOCDetectionIndex(voc_fixture, "train",
                                keep_difficult=keep_difficult)
    assert j.classes == t.classes and j.cls_to_id == t.cls_to_id
    assert len(j) == len(t) == 2
    for i in range(2):
        assert_same(j[i], t[i], f"sample {i}")
        assert_same(j.eval_record(i), t.eval_record(i), f"eval {i}")
    assert int(t.eval_record(0)[2].sum()) == 2      # both difficult flags


def test_transforms_equal():
    img = np.random.default_rng(1).integers(0, 256, (50, 70, 3), np.uint8)
    boxes = np.array([[3, 4, 30, 40], [10, 5, 60, 45]], np.float32)
    labels = np.array([2, 7], np.int32)

    def pipe(tf):
        return tf.Compose([tf.ResizeLetterbox(64), tf.ImageColorJitter(seed=5),
                           tf.TargetPadding(4), tf.ToFloat()])

    a = pipe(j_tf)(img, boxes.copy(), labels)
    b = pipe(t_tf)(img, boxes.copy(), labels)
    assert_same(a, b, "compose")
