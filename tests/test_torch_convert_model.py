"""``python -m tpucv_torch.convert_model`` on the CPU, as
``tests/test_checkpointing.py:164`` exercises tpucv's root converter:

- a full trainer bundle (Adam moments after a step, weight decay, the EMA)
  -> pure weights, equal to the bundle's model weights, whatever the
  optimizer's layout (``extract_from_checkpoint``);
- a torch ``.pt`` / ``.pth`` in each of tpucv's wrappings (a pickled
  module, ``{"model": module}`` (half precision, made float), ``{"state_dict":
  ...}`` and a bare state_dict) for yolo8_det, and a bare state_dict for
  yolo7 -> the same weights, loaded strictly
  (``extract_weights_from_torch_model``);
- the refusals, in tpucv's words: a ``.pt`` for another family, ``--int8``
  for a family without ``quantize_variables``, a calibration directory
  without images;
- ``main`` with ``--int8`` (the synthetic calibration set, and a
  ``--calib-dir``) at a 160 input: the file holds the quantized model's
  buffers (56 convs of YOLOv8n), and the predict and evaluate CLIs load it
  and run the int8 convs (``quant.quantized_conv`` is called).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucv_torch import convert_model as cm
from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.train.state import TrainState

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SIZE = 160


def _model(name, seed):
    cfg, algo_cls, _ = export_from_registry(name)
    return algo_cls(cfg, device="cpu").init_variables(seed)


def _assert_same(path, sd):
    got = CheckPoint.load_pure(path)
    assert got.keys() == sd.keys()
    for k in sd:
        assert torch.equal(got[k], sd[k].to(got[k].dtype)), k


def test_extracts_pure_weights_from_a_trainer_bundle(tmp_path):
    model = _model("yolo8_det", 3)
    state = TrainState.create(model, 1e-3, use_ema=True, weight_decay=1e-4)
    loss = sum(p.square().sum() for p in model.parameters())
    loss.backward()
    state.optimizer.step()
    src = str(tmp_path / "run_final.ckpt")
    CheckPoint.save(state, src)
    dst = str(tmp_path / "pure.ckpt")
    assert cm.extract_from_checkpoint("yolo8_det", src, dst, "cpu") == dst
    _assert_same(dst, model.state_dict())
    assert set(torch.load(dst, weights_only=True)) == set(model.state_dict())


@pytest.mark.parametrize("wrap", ["module", "model_dict", "state_dict",
                                  "bare"])
def test_torch_pt_in_each_wrapping(wrap, tmp_path):
    model = _model("yolo8_det", 5)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    obj = {"module": lambda: model,
           "model_dict": lambda: {"model": model.half(), "epoch": 3},
           "state_dict": lambda: {"state_dict": sd, "epoch": 3},
           "bare": lambda: sd}[wrap]()
    src = str(tmp_path / "ref.pt")
    torch.save(obj, src)
    if wrap == "model_dict":
        sd = {k: v.half().float() if v.is_floating_point() else v
              for k, v in sd.items()}
    dst = str(tmp_path / "out.ckpt")
    cm.extract_weights_from_torch_model("yolo8_det", src, dst, "cpu")
    _assert_same(dst, sd)


def test_torch_pth_for_yolo7(tmp_path):
    sd = _model("yolo7", 2).state_dict()
    src = str(tmp_path / "yolov7_l.pth")
    torch.save(sd, src)
    dst = cm.main(["--model", "yolo7", "--src", src, "--dst",
                   str(tmp_path / "y7.ckpt"), "--device", "cpu"])
    _assert_same(dst, sd)


def test_refusals(tmp_path):
    src = str(tmp_path / "ssd.pt")
    torch.save({}, src)
    with pytest.raises(NotImplementedError,
                       match=r"torch import supports \['yolo7', 'yolo8_det'\]; "
                             "other families load tpucv checkpoints directly"):
        cm.extract_weights_from_torch_model("ssd", src, src + ".out", "cpu")
    with pytest.raises(SystemExit, match="--int8 is not supported for "
                                         "vit_cls"):
        cm.quantize_checkpoint("vit_cls", src, src + ".q", device="cpu")
    os.makedirs(tmp_path / "empty")
    cfg, _, _ = export_from_registry("yolo8_det")
    with pytest.raises(SystemExit, match="no images found"):
        cm.calibration_index(cfg, str(tmp_path / "empty"))
    with pytest.raises(NotImplementedError):
        cm.main(["--model", "centernet", "--src", src, "--dst",
                 src + ".out", "--device", "cpu"])


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The converter's and the CLIs' registry at input 160, f32, run in
    ``tmp_path``."""
    from tpucv_torch import evaluate, predict

    def shrunk(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.dataset.input_size = SIZE
        cfg.train.mixed_precision = False
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (cm, predict, evaluate):
        monkeypatch.setattr(mod, "export_from_registry", shrunk)
    return predict, evaluate


def _images(tmp_path, n=3):
    import cv2
    rng = np.random.default_rng(9)
    out = tmp_path / "imgs"
    os.makedirs(out, exist_ok=True)
    for i in range(n):
        cv2.imwrite(str(out / f"{i}.jpg"),
                    rng.integers(0, 256, (120, 160, 3), np.uint8))
    return out


def _counting_int8(monkeypatch):
    calls = []
    real = quant.quantized_conv
    monkeypatch.setattr(quant, "quantized_conv",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def test_int8_bundle_loads_in_predict_and_evaluate(small, tmp_path,
                                                   monkeypatch, capsys):
    predict, evaluate = small
    src = str(tmp_path / "pure.ckpt")
    CheckPoint.save_pure(_model("yolo8_det", 0), src)
    dst = cm.main(["--model", "yolo8_det", "--src", src, "--dst",
                   str(tmp_path / "int8.ckpt"), "--int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "calibrating on synthetic data" in out
    assert f"wrote {dst} (56 convs int8)" in out
    assert sum(k.endswith(".qweight") for k in CheckPoint.load_pure(dst)) == 56

    calls = _counting_int8(monkeypatch)
    imgs = _images(tmp_path)
    results = predict.main(["--model", "yolo8_det", "--device", "cpu",
                            "--ckpt", dst, "--src", str(imgs / "0.jpg"),
                            "--dst", "out"])
    assert len(results) == 1 and calls
    root = tmp_path / "coco"
    subprocess.run([sys.executable, "scripts/make_synthetic_coco.py",
                    "--root", str(root), "--n", "2"], check=True, cwd=ROOT)
    monkeypatch.setenv("TPUCV_COCO_ROOT", str(root))
    n = len(calls)
    stats = evaluate.main(["--model", "yolo8_det", "--dataset", "coco",
                           "--device", "cpu", "--batch-size", "2", "--ckpt",
                           dst])
    assert len(stats) == 12 and len(calls) > n


def test_int8_calibrates_on_a_directory(small, tmp_path, capsys):
    src = str(tmp_path / "pure.ckpt")
    CheckPoint.save_pure(_model("yolo8_det", 0), src)
    imgs = _images(tmp_path, 2)
    dst = cm.main(["--model", "yolo8_det", "--src", src, "--dst",
                   str(tmp_path / "q.ckpt"), "--int8", "--calib-dir",
                   str(imgs), "--device", "cpu"])
    assert "synthetic" not in capsys.readouterr().out
    sd = CheckPoint.load_pure(dst)
    assert sum(k.endswith(".qweight") for k in sd) == 56
