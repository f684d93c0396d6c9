"""The port's host C++ libraries (``tpucv_torch/native/``) on the CPU.

- COCOeval: the port's C++ core (``native/cocoeval.cpp`` through
  ``COCOMeanAP.accumulate(use_native=True)``) against tpucv's **numpy**
  engine, and against the port's own numpy engine, on tpucv's fuzz
  fixtures (crowds, score ties, area ranges, empty cells; empty dts, empty
  gts): precision and recall within 1e-12, the 12 stats likewise. tpucv's
  own ``.so`` is never used, so its build does not matter here.
- imagepipe: ``decode_jpeg``, ``decode_to_canvas`` and ``nearest_resize``
  bit-equal to cv2 (colour, grayscale, a large image, non-JPEG, corrupt
  and missing files, failed rows), and ``read_image`` /
  ``_fill_canvases`` equal on their native and cv2 paths.
- the build: 4 processes building both libraries into one fresh build
  directory at once all load them (each compiler writes a name of its own
  process before ``os.replace``); a failed build is remembered on disk
  and not run again.

g++ and libjpeg's headers are on this machine, so the libraries must
build: a build failure fails these tests rather than skipping them.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tpucv.metrics.coco_map import COCOMeanAP as TpucvCOCOMeanAP
from tpucv_torch.metrics.coco_map import COCOMeanAP
from tpucv_torch.native import imagepipe as ip
from tpucv_torch.native import load

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-12


def _fuzz(seed, n_img=6, n_cat=4, n_gt=30, n_dt=60):
    """tpucv's fixture (tests/test_cocoeval_native.py): random boxes over
    6 images and 4 categories, 15% crowds, scores rounded to 0.01 (ties)."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(n_gt):
        w, h = rng.uniform(2, 120, 2)
        x, y = rng.uniform(0, 200, 2)
        gts.append({"image_id": int(rng.integers(1, n_img + 1)),
                    "category_id": int(rng.integers(1, n_cat + 1)),
                    "bbox": [x, y, w, h], "area": float(w * h),
                    "iscrowd": int(rng.random() < 0.15)})
    for _ in range(n_dt):
        w, h = rng.uniform(2, 120, 2)
        x, y = rng.uniform(0, 200, 2)
        dts.append({"image_id": int(rng.integers(1, n_img + 1)),
                    "category_id": int(rng.integers(1, n_cat + 1)),
                    "bbox": [x, y, w, h],
                    "score": round(float(rng.random()), 2)})
    return gts, dts, list(range(1, n_cat + 1))


def _case(name):
    if name == "empty_dts":
        gts, _, cats = _fuzz(0)
        return gts, [], cats
    if name == "empty_gts":
        _, dts, cats = _fuzz(0)
        return [], dts, cats
    return _fuzz(int(name[len("seed"):]))


CASES = [f"seed{s}" for s in range(6)] + ["empty_dts", "empty_gts"]


def _assert_same(a, b, stats=True):
    np.testing.assert_allclose(a.precision, b.precision, atol=ATOL, rtol=0)
    np.testing.assert_allclose(a.recall, b.recall, atol=ATOL, rtol=0)
    if not stats:
        return
    sa, sb = a.summarize(), b.summarize()
    assert sa.keys() == sb.keys() and len(sa) == 12
    for k in sa:
        assert abs(sa[k] - sb[k]) <= ATOL, k


def test_libraries_build():
    assert load("cocoeval") is not None
    assert ip.available()


@pytest.mark.parametrize("name", CASES)
def test_native_cocoeval_matches_tpucv_numpy(name):
    gts, dts, cats = _case(name)
    ref = TpucvCOCOMeanAP(gts, dts, cats).accumulate(use_native=False)
    got = COCOMeanAP(gts, dts, cats).accumulate(use_native=True)
    _assert_same(ref, got)


@pytest.mark.parametrize("name", CASES)
def test_native_cocoeval_matches_port_numpy(name):
    gts, dts, cats = _case(name)
    ref = COCOMeanAP(gts, dts, cats).accumulate(use_native=False)
    got = COCOMeanAP(gts, dts, cats).accumulate(use_native=True)
    _assert_same(ref, got)


def test_native_refuses_overridden_matching_hooks():
    """A subclass with its own matching hook must not take the bbox-only
    C++ core; one that overrides only protocol parameters keeps it."""
    gts, dts, cats = _fuzz(0)

    class CustomIoU(COCOMeanAP):
        def _iou(self, dts_, gts_, iscrowd):
            return super()._iou(dts_, gts_, iscrowd)

    assert not CustomIoU(gts, dts, cats)._accumulate_native()
    with pytest.raises(RuntimeError):
        CustomIoU(gts, dts, cats).accumulate(use_native=True)

    class CustomParams(COCOMeanAP):
        max_dets = (1, 10, 50)

    # (summarize reads maxDets=100, which these parameters lack)
    _assert_same(CustomParams(gts, dts, cats).accumulate(use_native=False),
                 CustomParams(gts, dts, cats).accumulate(use_native=True),
                 stats=False)


# ------------------------------------------------------------- imagepipe
def _jpg(tmp_path, name, img, quality=92):
    p = str(tmp_path / name)
    assert cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                       [cv2.IMWRITE_JPEG_QUALITY, quality])
    return p


def _rand_rgb(rng, h, w):
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 2)


def _cv2_read(p):
    bgr = cv2.imread(p, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("shapes", [
    (480, 640, 213, 284), (37, 53, 640, 640),
    (640, 640, 320, 213), (101, 99, 384, 384),
])
def test_nearest_resize_matches_cv2(shapes):
    sh, sw, dh, dw = shapes
    img = np.random.default_rng(0).integers(0, 256, (sh, sw, 3)) \
        .astype(np.uint8)
    np.testing.assert_array_equal(
        ip.nearest_resize(img, (dh, dw)),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError):
        ip.nearest_resize(img[..., 0], (dh, dw))


@pytest.mark.parametrize("hw", [(480, 640), (333, 500), (50, 60),
                                (1100, 1400)])
def test_decode_jpeg_bit_equal_to_cv2(tmp_path, hw):
    """(1100, 1400) needs more than the 4 MiB probe buffer: the retry."""
    p = _jpg(tmp_path, "c.jpg", _rand_rgb(np.random.default_rng(1), *hw))
    nat = ip.decode_jpeg(p)
    assert nat is not None and nat.shape == (*hw, 3)
    np.testing.assert_array_equal(nat, _cv2_read(p))


def test_decode_jpeg_grayscale_and_failures(tmp_path):
    g = np.random.default_rng(2).integers(0, 256, (64, 48)).astype(np.uint8)
    gray = str(tmp_path / "gray.jpg")
    assert cv2.imwrite(gray, g)
    np.testing.assert_array_equal(ip.decode_jpeg(gray), _cv2_read(gray))
    png = str(tmp_path / "a.png")
    assert cv2.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    bad = str(tmp_path / "bad.jpg")
    Path(bad).write_bytes(b"\xff\xd8\xff\xe0junk")
    for p in (png, bad, str(tmp_path / "missing.jpg")):
        assert ip.decode_jpeg(p) is None


def test_decode_to_canvas_matches_cv2_and_marks_failed_rows(tmp_path):
    """The eval harness's canvas layout with the oversized pre-shrink;
    failed rows (corrupt, PNG) come back zeroed with ok False; rows past
    the paths of a preallocated buffer are untouched."""
    rng = np.random.default_rng(4)
    sizes = [(480, 640), (427, 640), (720, 960), (33, 47)]
    paths = [_jpg(tmp_path, f"d{i}.jpg", _rand_rgb(rng, h, w))
             for i, (h, w) in enumerate(sizes)]
    bad = str(tmp_path / "x.jpg")
    Path(bad).write_bytes(b"nope")
    png = str(tmp_path / "p.png")
    assert cv2.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    paths = paths[:2] + [bad] + paths[2:] + [png]
    C = 640
    buf = np.zeros((len(paths) + 1, C, C, 3), np.uint8)
    buf[-1] = 7
    out, hw, orig, ok = ip.decode_to_canvas(paths, C, out=buf)
    assert out is buf
    assert ok.tolist() == [True, True, False, True, True, False]
    for j, p in enumerate(paths):
        if not ok[j]:
            assert (out[j] == 0).all()
            continue
        img = _cv2_read(p)
        oh, ow = img.shape[:2]
        if oh > C or ow > C:
            pre = C / max(oh, ow)
            img = cv2.resize(img, (int(ow * pre), int(oh * pre)),
                             interpolation=cv2.INTER_NEAREST)
        h, w = img.shape[:2]
        ref = np.zeros((C, C, 3), np.uint8)
        ref[:h, :w] = img
        np.testing.assert_array_equal(out[j], ref)
        assert tuple(hw[j]) == (h, w) and tuple(orig[j]) == (oh, ow)
    assert (buf[-1] == 7).all()
    with pytest.raises(ValueError):
        ip.decode_to_canvas(paths, C, out=np.zeros((1, C, C, 3), np.uint8))


def test_parity_gate_turns_the_native_decode_off(tmp_path, monkeypatch):
    p = _jpg(tmp_path, "p.jpg", _rand_rgb(np.random.default_rng(6), 32, 32))
    assert ip._decode_parity_ok()
    monkeypatch.setitem(ip._PARITY, "ok", False)
    assert not ip.available()
    assert ip.decode_jpeg(p) is None
    assert ip.decode_to_canvas([p], 64) is None


def test_read_image_and_fill_canvases_native_equal_cv2(tmp_path, monkeypatch):
    """``read_image`` (JPEG native, PNG through cv2) and the eval harness's
    ``_fill_canvases`` (a batch of JPEGs, one oversized, one PNG) give the
    same arrays with the native library and with it turned off."""
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.utils.image_process import read_image

    rng = np.random.default_rng(7)
    jpgs = [_jpg(tmp_path, f"r{i}.jpg", _rand_rgb(rng, h, w))
            for i, (h, w) in enumerate([(123, 234), (700, 500), (480, 640)])]
    png = str(tmp_path / "r.png")
    rgb = rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
    assert cv2.imwrite(png, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(read_image(jpgs[0]), _cv2_read(jpgs[0]))
    np.testing.assert_array_equal(read_image(png), rgb)

    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    algo = algo_cls(cfg, device="cpu")
    index = [(p,) for p in jpgs + [png]]
    native = algo._fill_canvases(index, range(4), 5, 640,
                                 out=np.full((5, 640, 640, 3), 255, np.uint8))
    monkeypatch.setitem(ip._PARITY, "ok", False)
    fallback = algo._fill_canvases(
        index, range(4), 5, 640, out=np.full((5, 640, 640, 3), 255, np.uint8))
    np.testing.assert_array_equal(native[0], fallback[0])
    np.testing.assert_array_equal(native[1], fallback[1])
    assert native[2] == fallback[2]
    assert native[3] == fallback[3]


# ------------------------------------------------------------ the build
RACE = r"""
import sys, time
from pathlib import Path
from tpucv_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.002)
from tpucv_torch.native import load, imagepipe
print(load("cocoeval") is not None, imagepipe.available())
"""


def test_concurrent_builds_into_one_fresh_directory(tmp_path):
    build_dir, go = tmp_path / "build", tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RACE, str(build_dir), str(go)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    time.sleep(0.5)              # all four waiting at the line
    go.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        outs.append((p.returncode, out.strip(), err[-2000:]))
    assert all(o[:2] == (0, "True True") for o in outs), outs
    built = sorted(f.name for f in build_dir.iterdir())
    assert len(built) == 2, built            # no temporary left behind
    assert built[0].startswith("libcocoeval-") and built[1].startswith(
        "libimagepipe-")


def test_failed_native_build_is_remembered_on_disk(tmp_path, monkeypatch):
    """A source that does not compile raises, leaves ``lib<name>-<digest>
    .failed`` with g++'s output and no library or temporary; a second call
    raises from that file without running g++ again, and ``load`` returns
    None."""
    from tpucv_torch import _build
    from tpucv_torch import native

    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text('#include "no_such_header.h"\n')
    monkeypatch.setattr(_build, "NATIVE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no_such_header"):
        _build.build_native("broken")
    marker = _build.native_path("broken").with_suffix(".failed")
    assert [f.name for f in (tmp_path / "build").iterdir()] == [marker.name]
    assert "no_such_header" in marker.read_text()

    def no_compiler(*a, **kw):
        raise AssertionError("g++ ran again")

    monkeypatch.setattr(_build, "_compile", no_compiler)
    with pytest.raises(RuntimeError, match="failed before"):
        _build.build_native("broken")
    monkeypatch.setattr(native, "_LIBS", {})
    assert native.load("broken") is None
