"""YOLOv7 as a slice: tpucv_torch's algorithm, trainer, int8 path and CLIs
against tpucv's, in f32 on the CPU at phi l, full width, small inputs.
Weights as in ``test_torch_yolov7.py`` (the port's seeded init with
BatchNorm drawn from a numpy seed, carried into flax by
``import_yolov7``). Held:

- ``make_infer_fn`` at 128² (K = 1,008: the NMS kernel's plain version)
  with the objectness and class rows of the head sharpened (biases 0,
  kernels x3000, so every score is 0 or 1 and ties order by anchor):
  valid and classes equal, boxes within 1e-3 px, scores within 1e-5
  (``test_torch_predict.py``'s bounds);
- 2 trainer steps against tpucv's on one tiny config (64², B=2, M=4,
  synthetic data, device augmentation and mosaic in both): the loss and
  its terms within 1e-3 relative at both steps, ``num_match`` equal at
  step 1, the logged learning rates equal. YOLOv8n's trainer test holds
  step 1 to 2e-5; here the train-mode forward through ~100 batch-
  statistics BatchNorms carries f32 rounding of 1e-3 on outputs of 3-5
  (``test_torch_yolov7.py``), and step 1's box_loss parts by 1.8e-4
  relative (measured: 1.7140 against 1.7137; obj 4.4408 both, cls
  1.8067 against 1.8066);
- int8 (tpucv's ``test_quantize_yolov7_close``): the port's calibration
  quantizes as many convs as tpucv's, RepConv and the head convs stay
  float in both, and with tpucv's quant collection carried across every
  quantized conv's int8 activation and int32 accumulators are bit-equal
  to tpucv's quantize step and ``lax.conv_general_dilated`` on the same
  input;
- the train, predict and evaluate CLIs' ``main`` with ``--model yolo7
  --device cpu`` at 64² (evaluate over a VOC root the test writes; predict
  and evaluate again with ``--int8``), and ``serve --int8``'s build.
"""

import copy
import os
import xml.etree.ElementTree as ET

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import Recorder
from test_torch_yolov7 import NC, _numpy_sd, _pair, flax_tree
from tpucv import quant as jq
from tpucv.algorithms.yolov7 import YOLOv7 as JYOLOv7
from tpucv.builder import export_from_registry as tpucv_export
from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.configs.dataset_cfg import VOC_CLASSES
from tpucv_torch.models.yolov7 import Yolo7
from tpucv_torch.ops import int8_conv

torch.set_num_threads(1)
BOX_PX_TOL, SCORE_TOL = 1e-3, 1e-5
REL_STEP = 1e-3
CLS_GAIN = 3000.0


def sharpen(model):
    """Objectness and class rows of each head conv: biases 0, kernels
    x3000."""
    with torch.no_grad():
        for i in (3, 4, 5):
            head = getattr(model, f"yolo_head_P{i}")
            rows = head.weight.view(3, 5 + NC, -1)
            rows[:, 4:] *= CLS_GAIN
            head.bias.view(3, 5 + NC)[:, 4:] = 0.0
    return model


def _configs(size, mixed=False):
    jcfg, _, _ = tpucv_export("yolo7")
    tcfg, t_algo, _ = export_from_registry("yolo7")
    for c in (jcfg, tcfg):
        c.dataset.input_size = size
        c.train.mixed_precision = mixed
    return jcfg, tcfg, t_algo


def test_make_infer_fn_equals_tpucv():
    jcfg, tcfg, t_algo = _configs(128)
    model = sharpen(copy.deepcopy(_pair("l")[2]))
    variables = flax_tree(_numpy_sd(model), "l")
    j = JYOLOv7(jcfg)
    t = t_algo(tcfg, device="cpu")
    imgs = np.random.default_rng(3).integers(0, 255, (2, 128, 128, 3),
                                             dtype=np.uint8)
    ref = [np.asarray(r) for r in j.make_infer_fn(j.build_model())(
        variables, jnp.asarray(imgs))]
    got = [g.numpy() for g in t.make_infer_fn()(model, torch.from_numpy(imgs))]
    assert got[3].sum() > 10 and np.all(got[1][got[3]] == 1.0)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[2][got[3]], ref[2][ref[3]])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=BOX_PX_TOL)


def _shrink(cfg, root):
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = 2
    cfg.train.mixed_precision = False
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    return cfg


def test_trainer_steps_equal_tpucv(tmp_path, monkeypatch):
    """Both trainers from the port's seed-0 init (tpucv's ``init_variables``
    returns it, which also skips its 12 s ``jax.jit(model.init)``)."""
    tcfg, _, t_cls = export_from_registry("yolo7")
    t = t_cls(_shrink(tcfg, tmp_path / "port"), device="cpu")
    tree = flax_tree(_numpy_sd(t.model), "l")
    monkeypatch.setattr(JYOLOv7, "init_variables",
                        lambda self, model=None, seed=0: tree)
    jcfg, _, j_cls = tpucv_export("yolo7")
    j = j_cls(_shrink(jcfg, tmp_path / "tpucv"))
    j.tb, t.tb = Recorder(), Recorder()
    j.train(max_steps=2)
    t.train(max_steps=2)
    assert t.LOSS_BATCH_SCALED is False
    for k in ("loss", "box_loss", "obj_loss", "cls_loss"):
        for step in (1, 2):
            np.testing.assert_allclose(
                t.tb.rows[f"train/{k}"][step], j.tb.rows[f"train/{k}"][step],
                rtol=REL_STEP, err_msg=f"{k} step {step}")
    assert t.tb.rows["train/num_match"][1] == j.tb.rows["train/num_match"][1]
    assert t.tb.rows["train/num_match"][1] > 0
    for step in (1, 2):
        assert t.tb.rows["lr"][step] == pytest.approx(j.tb.rows["lr"][step],
                                                      rel=1e-6)
    assert (tmp_path / "port" / "saves" / "yolo7_voc_final.ckpt").is_file()


def test_int8_counts_float_repconv_and_bit_equal_accumulators():
    jm, variables, model = _pair("l")
    x = np.random.default_rng(8).random((1, 64, 64, 3), np.float32)
    qv = jq.quantize_for_inference(jm, variables, [jnp.asarray(x)])
    jquant = qv["quant"]
    n = jq.count_quantized(jquant)
    assert n > 30
    assert not [k for k in jquant if k.startswith(("rep", "head"))]
    xt = torch.from_numpy(x)
    own = quant.quantize_for_inference(model, [xt])
    assert quant.count_quantized(own) == n
    assert all(not name.startswith(("rep_conv", "yolo_head"))
               for name, m in quant.hooked(own) if m.qweight is not None)

    # tpucv's quant collection carried across; the same input into each
    # quantized conv for both engines
    q = Yolo7(nc=NC, phi="l")
    q.load_state_dict(from_flax_variables(qv), strict=True)
    q.eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: seen.append((name, mod, inp[0])))
        for name, m in quant.hooked(q) if m.qweight is not None]
    try:
        with torch.no_grad():
            q(xt)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == n
    # tpucv's entries by their HWIO kernel (each is distinct)
    entries = {}
    for path, v in jax.tree_util.tree_leaves_with_path(jquant):
        keys = tuple(p.key for p in path)
        entries.setdefault(keys[:-1], {})[keys[-1]] = v
    assert len(entries) == n
    by_kernel = {np.asarray(e["conv::qkernel"]).tobytes(): e
                 for e in entries.values()}
    assert len(by_kernel) == n
    for name, m, xi in seen:
        c = m.conv
        xq = quant.quantize_activation(xi, m.xscale)
        acc = int8_conv.conv_plain(xq, m.qweight, c.kernel_size, c.stride,
                                   c.padding, c.dilation, c.groups)
        hwio = m.qweight.numpy().reshape(
            c.out_channels, c.kernel_size[0], c.kernel_size[1],
            -1).transpose(1, 2, 3, 0)
        e = by_kernel[hwio.tobytes()]
        jx = jnp.asarray(xi.permute(0, 2, 3, 1).numpy())
        jxq = jnp.clip(jnp.round(jx * (1.0 / e["conv::xscale"])),
                       -127.0, 127.0).astype(jnp.int8)
        np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jxq), err_msg=name)
        p = c.padding[0]
        jacc = jax.lax.conv_general_dilated(
            jxq, e["conv::qkernel"], c.stride, ((p, p), (p, p)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jacc), err_msg=name)


# -------------------------------------------------------------------- CLIs
def write_voc_root(root, n=4, size=(96, 128), seed=0):
    """A VOC devkit of ``n`` JPEGs with one or two objects each (one
    difficult) and ``ImageSets/Main/val.txt``."""
    rng = np.random.default_rng(seed)
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ids = []
    h, w = size
    for i in range(n):
        img_id = f"{i:06d}"
        ids.append(img_id)
        cv2.imwrite(os.path.join(root, "JPEGImages", f"{img_id}.jpg"),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        ann = ET.Element("annotation")
        for j in range(1 + i % 2):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = VOC_CLASSES[(3 * i + j) % 20]
            ET.SubElement(obj, "difficult").text = str(int(j == 1))
            bb = ET.SubElement(obj, "bndbox")
            x1, y1 = rng.integers(0, w // 2), rng.integers(0, h // 2)
            for k, v in (("xmin", x1), ("ymin", y1), ("xmax", x1 + w // 3),
                         ("ymax", y1 + h // 3)):
                ET.SubElement(bb, k).text = str(int(v))
        ET.ElementTree(ann).write(
            os.path.join(root, "Annotations", f"{img_id}.xml"))
    with open(os.path.join(root, "ImageSets", "Main", "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return [os.path.join(root, "JPEGImages", f"{i}.jpg") for i in ids]


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """The CLIs' registry lookup at input 64, f32; runs in tmp_path."""
    from tpucv_torch import evaluate, predict, serve
    from tpucv_torch.train import __main__ as train

    def shrunk(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.dataset.input_size = 64
        cfg.train.mixed_precision = False
        cfg.log.tensorboard_on = False
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate, train, serve):
        monkeypatch.setattr(mod, "export_from_registry", shrunk)
    return train, predict, evaluate, serve


def test_clis_on_the_cpu(small_cli, tmp_path, monkeypatch, capsys):
    train, predict, evaluate, serve = small_cli
    train.main(["--model", "yolo7", "--device", "cpu", "--max-steps", "1",
                "--batch-size", "2"])
    ckpt = tmp_path / "saves" / "yolo7_voc_final.ckpt"
    assert ckpt.is_file()
    imgs = write_voc_root(str(tmp_path / "voc"))
    res = predict.main(["--model", "yolo7", "--device", "cpu", "--ckpt",
                        str(ckpt), "--src", imgs[0], "--dst",
                        str(tmp_path / "det")])
    assert len(res) == 1 and os.path.isfile(res[0]["saved"])
    q = predict.main(["--model", "yolo7", "--device", "cpu", "--int8",
                      "--src", *imgs[:2], "--dst", str(tmp_path / "q")])
    assert len(q) == 2 and all(os.path.isfile(r["saved"]) for r in q)
    monkeypatch.setenv("TPUCV_VOC_ROOT", str(tmp_path / "voc"))
    out = evaluate.main(["--model", "yolo7", "--device", "cpu", "--ckpt",
                         str(ckpt), "--batch-size", "2"])
    assert "mAP" in out and "coco" in out
    q = evaluate.main(["--model", "yolo7", "--device", "cpu", "--int8",
                       "--batch-size", "2"])
    assert "mAP" in q
    server = serve.build(["--model", "yolo7", "--device", "cpu", "--host",
                          "127.0.0.1", "--port", "0", "--int8", "--calib",
                          str(tmp_path / "voc" / "JPEGImages")])
    try:
        assert quant.count_quantized(server.batcher.model) > 30
    finally:
        server.batcher.stop()
        server.server_close()
    assert "yolo7" in capsys.readouterr().out
