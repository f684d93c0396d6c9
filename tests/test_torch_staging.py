"""The batched detect loop's canvas staging (``algorithms/base.py``:
``CanvasStaging``, ``_fill_canvases``, ``_staged_batch``), on the CPU.

- ``_fill_canvases`` into a reused buffer first filled with 255 gives the
  bytes of tpucv's ``_fill_canvases`` (a fresh zeroed array), over three
  calls whose images shrink (every stale margin, and the rows a short
  batch leaves empty, zeroed): raw ndarrays with one image pre-shrunk, and
  JPEG paths through the native decode with a PNG among them (a row the
  native code fails and cv2 places).
- ``_batched_detections`` reuses one staging while (B, C) holds (same
  memory, ``allocations`` 1, ``reuses`` a batch after the first) and
  replaces it on a new batch size; YOLOv8-pose's evaluation loop and the
  int8 calibration of ``quantize_variables`` take the same staging.
- YOLOv8n and YOLOv7 at 64², over consecutive batches of mixed shapes
  with the staging first filled with 255: the detections equal those of
  a run whose every canvas is tpucv's fresh array.
- More threads than cores calling ``_batched_detections`` on one
  algorithm at once each get the results of a sequential run.
"""

import os
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv_torch.algorithms.base import CanvasStaging
from tpucv_torch.builder import export_from_registry
from tpucv_torch.native import imagepipe

torch.set_num_threads(1)

SIZE = 64
C = 640
SHAPES = [(480, 640), (640, 427), (120, 90), (33, 47), (640, 640),
          (300, 200)]


def _algo(name="yolo8_det", size=SIZE):
    cfg, algo_cls, _ = export_from_registry(name)
    cfg.dataset.input_size = size
    cfg.train.mixed_precision = False
    return algo_cls(cfg, device="cpu")


def _images(rng, shapes, scale=1.0):
    return [rng.integers(0, 256, (max(int(h * scale), 1),
                                  max(int(w * scale), 1), 3), np.uint8)
            for h, w in shapes]


def _same(got, want):
    canvases, hw, oshapes, prescales = got
    np.testing.assert_array_equal(canvases, want[0])
    np.testing.assert_array_equal(hw, want[1])
    assert oshapes == want[2] and prescales == want[3]


def _ndarray_batches(rng):
    """Three batches whose images shrink, the last one short; the first
    holds an image larger than the canvas (pre-shrunk)."""
    big = [(700, 500)] + SHAPES[:5]
    return [[(im,) for im in _images(rng, big)],
            [(im,) for im in _images(rng, SHAPES, 0.5)],
            [(im,) for im in _images(rng, SHAPES[:3], 0.2)]]


def _jpeg_batches(rng, tmp_path):
    batches = []
    for k, scale in enumerate((1.0, 0.5, 0.2)):
        paths = []
        for j, img in enumerate(_images(rng, SHAPES, scale)):
            ext = "png" if j == 2 else "jpg"
            paths.append(str(tmp_path / f"b{k}_{j}.{ext}"))
            assert cv2.imwrite(paths[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        batches.append([(p,) for p in paths[:6 - 2 * k]])
    return batches


@pytest.fixture(scope="module")
def tpucv_fill():
    """tpucv's ``_fill_canvases``: each batch on a fresh zeroed array."""
    cfg, algo_cls, _ = tpucv_export("yolo8_det")
    return algo_cls(cfg)._fill_canvases


@pytest.mark.parametrize("source", ["ndarray", "jpeg"])
def test_reused_buffer_equals_fresh_array(source, tmp_path, tpucv_fill):
    rng = np.random.default_rng(1)
    if source == "jpeg":
        assert imagepipe.available()
        batches = _jpeg_batches(rng, tmp_path)
        # the PNG is a row the native decode fails: cv2 places it
        ok = imagepipe.decode_to_canvas([p for p, in batches[0]], C)[3]
        assert ok.tolist() == [True, True, False, True, True, True]
    else:
        batches = _ndarray_batches(rng)
    algo = _algo()
    B = 6
    buf = np.full((B, C, C, 3), 255, np.uint8)
    for index in batches:
        fresh = tpucv_fill(index, range(len(index)), B, C)
        staged = algo._fill_canvases(index, range(len(index)), B, C, out=buf)
        assert staged[0] is buf
        _same(staged, fresh)
    assert (buf[len(batches[-1]):] == 0).all()


def test_out_of_another_shape_is_refused():
    algo = _algo()
    index = [(np.ones((8, 8, 3), np.uint8),)]
    for bad in (np.zeros((2, 64, 64, 3), np.uint8),
                np.zeros((1, 64, 64, 3), np.float32),
                np.zeros((1, 64, 64, 6), np.uint8)[..., ::2]):
        with pytest.raises(ValueError):
            algo._fill_canvases(index, range(1), 1, 64, out=bad)


def test_one_staging_reused_while_the_shape_holds():
    algo = _algo()
    model = algo.init_variables(seed=0)
    rng = np.random.default_rng(2)
    index = [(im,) for im in _images(rng, SHAPES, 0.1)]
    allocations, reuses = CanvasStaging.allocations, CanvasStaging.reuses
    pinned = CanvasStaging.pinned_bytes
    list(algo._batched_detections(model, index, 2, 0.25))
    stage = algo._staging
    ptr = stage._host[0].data_ptr()
    assert stage.canvases.ctypes.data == ptr
    list(algo._batched_detections(model, index[:3], 2, 0.25))
    assert algo._staging is stage and stage._host[0].data_ptr() == ptr
    assert CanvasStaging.allocations == allocations + 1
    assert CanvasStaging.reuses == reuses + 3 + 2 - 1
    assert CanvasStaging.pinned_bytes == pinned          # none on the CPU
    list(algo._batched_detections(model, index, 3, 0.25))
    assert algo._staging is not stage and algo._staging.key == (3, C)
    assert CanvasStaging.allocations == allocations + 2
    assert CanvasStaging.reuses == reuses + 4 + 1


@pytest.mark.parametrize("path", ["pose_eval", "int8_calibration"])
def test_pose_and_calibration_take_the_staging(path):
    """YOLOv8-pose's evaluation loop and ``quantize_variables``' batches go
    through ``_staged_batch``: one staging for (B, C), reused by every
    batch after the first."""
    rng = np.random.default_rng(4)
    index = [(im,) for im in _images(rng, SHAPES[:5], 0.1)]
    algo = _algo("yolo8_pose" if path == "pose_eval" else "yolo8_det")
    model = algo.init_variables(seed=0)
    allocations, reuses = CanvasStaging.allocations, CanvasStaging.reuses
    if path == "pose_eval":
        out = list(algo._batched_pose_detections(model, index, 2, 0.25))
        assert [o[0] for o in out] == list(range(len(index)))
    else:
        algo.quantize_variables(model, index, n_images=5, batch_size=2)
    assert algo._staging.key == (2, C)
    assert CanvasStaging.allocations == allocations + 1
    assert CanvasStaging.reuses == reuses + 2


def _fresh_run(algo, model, index, B, fill, monkeypatch):
    """``_batched_detections`` with every canvas tpucv's fresh zeroed array
    (``fill``), copied into the staging, which the upload reads."""

    def fresh(index, idxs, batch_size, C, out):
        got = fill(index, idxs, batch_size, C)
        out[...] = got[0]
        return (out,) + tuple(got[1:])

    with monkeypatch.context() as m:
        m.setattr(algo, "_fill_canvases", fresh)
        return list(algo._batched_detections(model, index, B, 0.25))


def _assert_same_detections(a, b):
    assert len(a) == len(b)
    for (i, boxes, scores, classes), (j, boxes2, scores2, classes2) in \
            zip(a, b):
        assert i == j
        np.testing.assert_array_equal(boxes, boxes2)
        np.testing.assert_array_equal(scores, scores2)
        np.testing.assert_array_equal(classes, classes2)


@pytest.fixture(scope="module", params=["yolo8_det", "yolo7"])
def detector(request):
    algo = _algo(request.param)
    model = algo.init_variables(seed=0)
    with torch.no_grad():
        for p in model.parameters():     # logits spread past conf 0.25
            p.mul_(1.5)
    rng = np.random.default_rng(3)
    # consecutive batches of 3 whose shapes differ batch to batch, the last
    # batch short
    index = [(im,) for im in _images(
        rng, [(64, 48), (60, 64), (64, 64), (20, 50), (30, 30), (8, 64),
              (64, 10), (50, 50)])]
    return algo, model, index


def test_batched_detections_equal_a_fresh_array_run(detector, tpucv_fill,
                                                    monkeypatch):
    algo, model, index = detector
    want = _fresh_run(algo, model, index, 3, tpucv_fill, monkeypatch)
    assert sum(len(b) for _, b, _, _ in want) > 0
    algo._staging.canvases[...] = 255
    got = list(algo._batched_detections(model, index, 3, 0.25))
    _assert_same_detections(got, want)


def test_threads_get_the_sequential_results(detector):
    """More callers than cores, on one algorithm, with the interpreter
    switching threads often: every run equals the sequential one."""
    algo, model, index = detector
    halves = [index[:5], index[3:]]
    want = [list(algo._batched_detections(model, h, 2, 0.25))
            for h in halves]
    n = len(os.sched_getaffinity(0)) + 2
    start = threading.Barrier(n)
    got = [[] for _ in range(n)]

    def worker(k):
        start.wait(timeout=60)
        for _ in range(2):
            got[k].append(list(algo._batched_detections(
                model, halves[k % 2], 2, 0.25)))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(n):
        assert len(got[k]) == 2
        for run in got[k]:
            _assert_same_detections(run, want[k % 2])
