"""Predict, drawing and the two CLIs of this slice, on the CPU.

- ``predict`` against tpucv's on one JPEG and one PNG (f32, input 160,
  tpucv's init with the class biases zeroed and the class kernels scaled
  by ``CLS_GAIN``, carried across with ``from_flax_variables``; conf
  0.25, so K <= 1024 and the NMS kernel's plain version runs): classes
  exactly, boxes within 1e-3 px, scores within 1e-5, and the drawn file
  saved as ``<name>@<timestamp>.jpg``.
- ``draw_detections`` bit-equal to tpucv's on one image, and the palette
  equal.
- ``python -m tpucv_torch.predict --device cpu`` (images, then a video)
  and ``python -m tpucv_torch.evaluate --device cpu`` (a 4-image COCO root
  from ``scripts/make_synthetic_coco.py`` through ``TPUCV_COCO_ROOT``)
  through their ``main``, the config shrunk to input 160; ``--int8`` is
  refused by name by both.
"""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv.utils import visualize as j_vis
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.utils import visualize as t_vis

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CLS_GAIN = 3000.0
SIZE = 160


def _image(h=427, w=640, seed=0):
    """Smooth gradients and noise: scores spread under the sharpened
    class branch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h,
                     (xx + yy) * 255 // (h + w)], -1)
    noise = rng.integers(-40, 41, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _write(path, rgb):
    assert cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    return str(path)


@pytest.fixture(scope="module")
def pair():
    jcfg, j_cls, _ = tpucv_export("yolo8_det")
    tcfg, t_cls, _ = export_from_registry("yolo8_det")
    for cfg in (jcfg, tcfg):
        cfg.train.mixed_precision = False
        cfg.dataset.input_size = SIZE
    j, t = j_cls(jcfg), t_cls(tcfg, device="cpu")
    variables = j.init_variables()
    params = {k: dict(v) for k, v in variables["params"].items()}
    for lv in range(3):
        head = dict(params["detect"][f"cv3_{lv}_2"])
        head["bias"] = np.zeros_like(head["bias"])
        head["kernel"] = np.asarray(head["kernel"]) * CLS_GAIN
        params["detect"][f"cv3_{lv}_2"] = head
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    model = t.init_variables()
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return j, variables, t, model


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_predict_equals_tpucv(pair, tmp_path, ext):
    j, variables, t, model = pair
    src = _write(tmp_path / f"img{ext}", _image())
    ref = j.predict(variables, src, save_dir=str(tmp_path / "j"))
    got = t.predict(model, src, save_dir=str(tmp_path / "t"))
    assert len(ref["classes"]) > 0
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got["image"], ref["image"])
    h, w = got["image"].shape[:2]
    assert got["boxes"].min() >= 0 and (got["boxes"][:, [0, 2]] <= w).all() \
        and (got["boxes"][:, [1, 3]] <= h).all()       # clipped
    saved = Path(got["saved"])
    assert saved.parent == tmp_path / "t" and saved.name.startswith("img@")
    assert cv2.imread(str(saved)).shape == (h, w, 3)
    assert t.predict(model, src, save_dir=None)["saved"] is None


def test_draw_detections_bit_equal_to_tpucv():
    assert t_vis.PALETTE == j_vis.PALETTE and len(t_vis.PALETTE) == 80
    img = _image(300, 400, seed=3)
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 300, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 120, (12, 2))], 1)
    scores = rng.random(12).astype(np.float32)
    classes = rng.integers(0, 80, 12)
    names = [f"class{k}" for k in range(80)]
    got = t_vis.draw_detections(img, boxes, scores, classes, names)
    ref = j_vis.draw_detections(img, boxes, scores, classes, names)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, img)


# --------------------------------------------------------------- the CLIs
@pytest.fixture
def small(monkeypatch, tmp_path):
    """The CLIs' registry lookup with the config at input 160, f32; runs in
    ``tmp_path``."""
    from tpucv_torch import evaluate, predict

    def shrunk(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.dataset.input_size = SIZE
        cfg.train.mixed_precision = False
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate):
        monkeypatch.setattr(mod, "export_from_registry", shrunk)
    return predict, evaluate


def test_predict_cli_images_and_video(small, tmp_path, capsys):
    predict, _ = small
    srcs = [_write(tmp_path / "a.jpg", _image()),
            _write(tmp_path / "b.png", _image(200, 300, seed=1))]
    results = predict.main(["--model", "yolo8_det", "--device", "cpu",
                            "--src", *srcs, "--dst", "out"])
    assert len(results) == 2
    assert sorted(p.split("@")[0] for p in os.listdir(tmp_path / "out")) \
        == ["a", "b"]
    assert "total time" in capsys.readouterr().out

    video = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                             (160, 120))
    for k in range(3):
        writer.write(cv2.cvtColor(_image(120, 160, seed=k),
                                  cv2.COLOR_RGB2BGR))
    writer.release()
    out = predict.main(["--model", "yolo8_det", "--device", "cpu",
                        "--type", "video", "--src", video, "--dst", "vid"])
    cap = cv2.VideoCapture(out[0])
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    assert frames == 3


def test_evaluate_cli_on_a_coco_root(small, tmp_path, monkeypatch):
    _, evaluate = small
    root = tmp_path / "coco"
    subprocess.run([sys.executable, "scripts/make_synthetic_coco.py",
                    "--root", str(root), "--n", "4"], check=True, cwd=ROOT)
    monkeypatch.setenv("TPUCV_COCO_ROOT", str(root))
    stats = evaluate.main(["--model", "yolo8_det", "--dataset", "coco",
                           "--device", "cpu", "--batch-size", "2"])
    assert len(stats) == 12
    assert all(-1.0 <= v <= 1.0 for v in stats.values())
    assert (tmp_path / "result" / "eval_results.json").is_file()


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
def test_int8_refused_by_name(small, cli, monkeypatch):
    """tpucv's refusal for an algorithm without ``quantize_variables``."""
    mod = small[0] if cli == "predict" else small[1]
    shrunk = mod.export_from_registry

    def no_int8(name):
        cfg, algo, trainer = shrunk(name)
        return cfg, type("NoInt8", (algo,), {"quantize_variables": None}), \
            trainer

    monkeypatch.setattr(mod, "export_from_registry", no_int8)
    with pytest.raises(SystemExit, match="--int8 is not supported for "
                                         "yolo8_det"):
        mod.main(["--model", "yolo8_det", "--device", "cpu", "--int8"])


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
def test_default_device_refuses_without_card(cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    import importlib
    mod = importlib.import_module(f"tpucv_torch.{cli}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--model", "yolo8_det"])
