"""DeepLabV3+ as a slice: tpucv_torch's algorithm, trainer, int8 path and
CLIs against tpucv's, in f32 on the CPU, on ResNet-50 at a 65² crop
(nc 21). Weights as in ``test_torch_deeplab.py`` (the port's seeded init
with BatchNorm and the classifier's bias drawn from a numpy seed, carried
into flax by ``import_deeplab``). Held:

- ``build_loss`` (tpucv's jitted), focal as shipped and CE, with ignored
  pixels: within 1e-5 relative;
- ``make_infer_fn`` (uint8 -> /255 -> ImageNet normalisation -> forward
  -> argmax) at B=2: the class maps equal wherever tpucv's top-2 logit
  gap exceeds the forward bound (1e-4 of the largest logit), at least
  99% of the pixels;
- ``run_eval`` / ``evaluate_on_voc`` over 8 synthetic samples (B=4): the
  histogram and every metric equal; the port's evaluations count the
  last partial batch (tpucv's loader drops it, and its trainer's 8
  synthetic val images at B=16 score nothing); ``predict`` on a JPEG: the
  class map and the blended overlay equal, the drawn file written;
- 2 trainer steps against tpucv's (B=2, synthetic data, f32) with the
  ASPP dropout mask shared (``test_torch_deeplab.SharedDropout``): the
  focal loss within 1e-3 relative at both steps, the logged learning
  rates equal, ``LOSS_BATCH_SCALED`` and ``DEVICE_AUG`` False; a run
  resumed from its epoch-0 checkpoint equal, bit for bit, to an unbroken
  one (weights, BatchNorm statistics, Adam's moments);
- int8 (tpucv's ``test_quantize_deeplab_via_algo``: both algorithms'
  ``quantize_variables`` on the same two images): the quantized conv
  count equal to tpucv's ``count_quantized`` (every conv + BN but the
  3-channel stem; the classifier float); the quantized logits within
  tpucv's own bar (0.15 of the largest) of tpucv's quantized logits; with
  tpucv's quant collection carried across, every quantized conv's int8
  activation and int32 accumulators (the dilated 3x3s and the 1x1 on the
  pool branch's 1x1 map included) bit-equal to tpucv's quantize step and
  ``lax.conv_general_dilated``;
- the train, predict and evaluate CLIs' ``main`` with ``--model
  deeplabv3plus --device cpu`` (evaluate over a VOC segmentation root the
  test writes; predict and evaluate again with ``--int8``), ``bench
  --model deeplabv3plus --small``, ``serve`` refusing the family, and
  predict without ``--device cpu`` refusing a machine with no card.
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_deeplab import (NC, numpy_sd, pair,  # noqa: F401
                                shared_dropout)
from test_torch_trainer import Recorder
from tpucv import quant as jq
from tpucv.algorithms.segmentation_2d import DeeplabV3PlusA as JAlgo
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt.importer import import_deeplab
from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.data.segmentation_dataset import (VOC_COLORMAP,
                                                   synthetic_seg_samples)
from tpucv_torch.models.deeplabv3plus import DeeplabV3Plus
from tpucv_torch.ops import int8_conv

torch.set_num_threads(1)
CROP = 65
LOSS_REL = 1e-5
FWD_REL = 1e-4
REL_STEP = 1e-3
INT8_REL = 0.15          # tests/test_quant.py's bar for DeepLab
COVERED_MIN = 0.99


def _small(cfg, crop=CROP):
    cfg.arch.backbone = "resnet50"
    cfg.arch.crop_size = cfg.arch.input_size = cfg.dataset.input_size = crop
    cfg.train.mixed_precision = False
    return cfg


def _algos():
    jcfg, _, _ = tpucv_export("deeplabv3plus")
    tcfg, t_algo, _ = export_from_registry("deeplabv3plus")
    return JAlgo(_small(jcfg)), t_algo(_small(tcfg), device="cpu")


def _uint8(b, s=CROP, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                dtype=np.uint8)


# -------------------------------------------------------------- algorithm
@pytest.mark.parametrize("name", ["focal", "ce"])
def test_build_loss_equals_tpucv(name):
    j, t = _algos()
    j.cfg.loss.name = t.cfg.loss.name = name
    rng = np.random.default_rng(1)
    raw = rng.normal(0, 2, (2, 33, 33, NC)).astype(np.float32)
    labels = rng.integers(0, NC, (2, 33, 33)).astype(np.int32)
    labels[rng.random((2, 33, 33)) < 0.2] = 255
    rt, rp = jax.jit(j.build_loss())(jnp.asarray(raw),
                                     {"labels": jnp.asarray(labels)})
    gt, gp = t.build_loss()(torch.from_numpy(raw).permute(0, 3, 1, 2),
                            {"labels": torch.from_numpy(labels)})
    assert sorted(gp) == sorted(rp) == [f"{name}_loss"]
    assert float(gt) == pytest.approx(float(rt), rel=LOSS_REL)


def test_make_infer_fn_equals_tpucv():
    j, t = _algos()
    jm, variables, model = pair()
    imgs = _uint8(2, seed=3)
    ref = np.asarray(j.make_infer_fn(jm)(variables, jnp.asarray(imgs)))
    got = t.make_infer_fn()(model, torch.from_numpy(imgs))
    assert got.dtype == torch.int32 and got.shape == (2, CROP, CROP)
    # tpucv's logits: where the top two are further apart than the
    # forward bound, the argmax cannot part
    from tpucv.ops.preprocess import imagenet_normalize, normalize_images
    logits = np.asarray(jm.apply(variables, imagenet_normalize(
        normalize_images(jnp.asarray(imgs), jnp.float32))))
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * FWD_REL * np.abs(logits).max()
    assert clear.mean() >= COVERED_MIN
    np.testing.assert_array_equal(got.numpy()[clear], ref[clear])
    assert len(np.unique(ref)) > 3


def test_evaluate_on_voc_equal():
    j, t = _algos()
    jm, variables, model = pair()
    samples = synthetic_seg_samples(8, CROP, NC, 1)
    ref = j.run_eval(variables, samples, batch_size=4)
    got = t.run_eval(model, samples, batch_size=4)
    assert sorted(got) == sorted(ref)
    for k in ("overall_acc", "mean_acc", "freq_weighted_acc", "mIoU"):
        assert got[k] == ref[k], k
    np.testing.assert_array_equal(got["per_class_iou"], ref["per_class_iou"])
    assert got["overall_acc"] > 0


def test_evaluation_scores_every_image(tmp_path, monkeypatch):
    """The last partial batch counts (tpucv's loader drops it): ``run_eval``
    over 6 samples at B=4 counts every labelled pixel of all 6, and the
    trainer's ``evaluate_loop`` over its 8 synthetic val images at B=16
    (one partial batch) scores them all, finite."""
    from tpucv_torch.metrics import seg_metrics

    _, t = _algos()
    samples = synthetic_seg_samples(6, CROP, NC, 2)
    hist = t.run_eval(pair()[2], samples, batch_size=4)
    seen = []
    real = seg_metrics.SegmentationMetrics.update

    def update(metrics, pred, label):
        seen.append(int((label != 255).sum()))
        real(metrics, pred, label)

    monkeypatch.setattr(seg_metrics.SegmentationMetrics, "update", update)
    t.run_eval(pair()[2], samples, batch_size=4)
    assert seen[-2:] and sum(seen) == 6 * CROP * CROP
    assert np.isfinite(hist["mIoU"])
    cfg, _, cls = export_from_registry("deeplabv3plus")
    trainer = cls(_shrink(cfg, tmp_path, batch_size=16), device="cpu")
    seen.clear()
    val = trainer.evaluate_loop(trainer.state)
    assert seen == [8 * CROP * CROP]
    assert np.isfinite(val["val_mIoU"]) and 0 <= val["val_acc"] <= 1


def test_predict_overlay_equal(tmp_path):
    j, t = _algos()
    jm, variables, model = pair()
    path = str(tmp_path / "img.jpg")
    cv2.imwrite(path, _uint8(1, 80, seed=5)[0, :, :70])
    ref = j.predict(variables, path, save_dir=str(tmp_path / "j"))
    got = t.predict(model, path, save_dir=str(tmp_path / "t"))
    assert got["class_map"].shape == (CROP, CROP)
    np.testing.assert_array_equal(got["class_map"], ref["class_map"])
    np.testing.assert_array_equal(got["overlay"], ref["overlay"])
    assert got["overlay"].shape == (80, 70, 3) and os.path.isfile(
        got["saved"])
    assert len(VOC_COLORMAP) == NC


# ---------------------------------------------------------------- trainer
def write_only(monkeypatch, module, keep=()):
    """``module``'s ``CheckPoint.save`` writing only the files whose names
    end in one of ``keep`` (a ResNet-50 bundle with Adam's moments is
    ~0.5 GB); returns the list of every path asked for."""
    asked = []
    real = module.CheckPoint.save

    def save(state, path):
        asked.append(os.path.basename(path))
        return real(state, path) if path.endswith(tuple(keep)) else path

    monkeypatch.setattr(module.CheckPoint, "save", staticmethod(save))
    return asked


def _shrink(cfg, root, batch_size=2):
    _small(cfg)
    cfg.train.batch_size = batch_size
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    return cfg


def test_trainer_steps_equal_tpucv(tmp_path, monkeypatch, shared_dropout):
    """Both trainers from the port's seed-0 init (tpucv's
    ``init_variables`` returns it, which also skips its
    ``jax.jit(model.init)``); the port trains first, so its two dropout
    masks are recorded before tpucv's steps ask for them."""
    from tpucv.trainer import base as jbase
    from tpucv_torch.trainer import base as tbase

    asked = write_only(monkeypatch, tbase)
    write_only(monkeypatch, jbase)
    tcfg, _, t_cls = export_from_registry("deeplabv3plus")
    t = t_cls(_shrink(tcfg, tmp_path / "port"), device="cpu")
    tree = import_deeplab(numpy_sd(t.model))
    monkeypatch.setattr(JAlgo, "init_variables",
                        lambda self, model=None, seed=0: tree)
    jcfg, _, j_cls = tpucv_export("deeplabv3plus")
    j = j_cls(_shrink(jcfg, tmp_path / "tpucv"))
    j.tb, t.tb = Recorder(), Recorder()
    hooks = shared_dropout.hook(t.model)
    t.train(max_steps=2)
    for h in hooks:
        h.remove()
    assert len(shared_dropout.masks) == 2
    assert not np.array_equal(*shared_dropout.masks)
    j.train(max_steps=2)
    assert len(shared_dropout.seen) == 2
    assert t.LOSS_BATCH_SCALED is False is j.LOSS_BATCH_SCALED
    assert t.DEVICE_AUG is False
    for k in ("loss", "focal_loss"):
        for step in (1, 2):
            np.testing.assert_allclose(
                t.tb.rows[f"train/{k}"][step], j.tb.rows[f"train/{k}"][step],
                rtol=REL_STEP, err_msg=f"{k} step {step}")
    for step in (1, 2):
        assert t.tb.rows["lr"][step] == pytest.approx(j.tb.rows["lr"][step],
                                                      rel=1e-6)
    assert asked == ["deeplabv3plus_voc_epoch-0.ckpt",
                     "deeplabv3plus_voc_final.ckpt"]


def test_resume_equals_an_unbroken_run(tmp_path, monkeypatch):
    """8 synthetic samples at B=4 (2 steps an epoch): 4 steps in one run,
    against 2 steps, a save at epoch 0 and 2 more steps in a new trainer
    resumed from it. The dropout masks, the data order and the Adam state
    all follow the step, so the two end bit-equal."""
    from tpucv_torch.trainer import base as tbase
    from tpucv_torch.trainer import segmentation_trainer as st

    asked = write_only(monkeypatch, tbase, keep=("b/saves/deeplabv3plus_voc_"
                                                 "epoch-0.ckpt",))
    monkeypatch.setattr(st, "synthetic_seg_samples",
                        lambda n, *a: synthetic_seg_samples(8, *a))
    cls = export_from_registry("deeplabv3plus")[2]

    def trainer(root, **train):
        cfg = _shrink(export_from_registry("deeplabv3plus")[0], root, 4)
        cfg.train.save_interval = 1
        cfg.train.eval_interval = 100
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return cls(cfg, device="cpu")

    whole = trainer(tmp_path / "a").train(max_steps=4)
    trainer(tmp_path / "b").train(max_steps=2)
    resumed = trainer(tmp_path / "b", resume_training=True,
                      last_epoch=0).train(max_steps=4)
    assert whole.step == resumed.step == 4
    assert asked.count("deeplabv3plus_voc_epoch-0.ckpt") == 2
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, s in sa["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], sb["state"][i][k]), (i, k)


# ------------------------------------------------------------------- int8
@functools.lru_cache(maxsize=None)
def _quantized():
    """tpucv's and the port's ``quantize_variables`` of the same DeepLab on
    two images of 80x96 (resized to the crop), and an input to compare."""
    j, t = _algos()
    jm, variables, model = pair()
    rng = np.random.default_rng(12)
    index = [rng.integers(0, 255, (80, 96, 3), dtype=np.uint8)
             for _ in range(2)]
    qv = j.quantize_variables(variables, index, n_images=2, batch_size=2)
    own = t.quantize_variables(model, index, n_images=2, batch_size=2)
    x = rng.random((1, CROP, CROP, 3), np.float32)
    return jm, variables, qv, model, own, x


def test_int8_counts_equal_tpucv():
    _, _, qv, model, own, _ = _quantized()
    n = jq.count_quantized(qv["quant"])
    assert n == quant.count_quantized(own) == 60
    names = {name for name, m in quant.hooked(own) if m.qweight is not None}
    assert "backbone.conv1" not in names                 # 3-channel stem
    assert {"classifier.aspp.convs.4.1", "classifier.aspp.convs.3.0",
            "classifier.project.0", "classifier.classifier.0",
            "backbone.layer4.2.conv2"} <= names
    assert quant.count_quantized(model) == 0          # the float one kept
    fresh = DeeplabV3Plus(NC, "resnet50")
    fresh.load_state_dict(own.state_dict(), strict=True)
    assert quant.count_quantized(fresh) == n


def test_int8_logits_within_tpucvs_bar():
    jm, variables, qv, model, own, x = _quantized()
    ref = np.asarray(jm.apply(qv, jnp.asarray(x)))
    float_ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = own.eval()(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= INT8_REL * scale
    assert np.abs(ref - float_ref).max() > 0               # quantized


def test_int8_accumulators_bit_equal_tpucv():
    """tpucv's quant collection carried across; the same input into each
    quantized conv for both engines."""
    _, _, qv, _, _, x = _quantized()
    q = DeeplabV3Plus(NC, "resnet50")
    q.load_state_dict(from_flax_variables(qv), strict=True)
    q.eval()
    n = jq.count_quantized(qv["quant"])
    assert quant.count_quantized(q) == n
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: seen.append((name, mod, inp[0])))
        for name, m in quant.hooked(q) if m.qweight is not None]
    try:
        with torch.no_grad():
            q(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == n
    dilated = 0
    for name, m, xi in seen:
        c = m.conv
        xq = quant.quantize_activation(xi, m.xscale)
        acc = int8_conv.conv_plain(xq, m.qweight, c.kernel_size, c.stride,
                                   c.padding, c.dilation, c.groups)
        k = np.asarray(m.qweight).reshape(
            c.out_channels, c.kernel_size[0], c.kernel_size[1],
            -1).transpose(1, 2, 3, 0)
        jx = jnp.asarray(xi.permute(0, 2, 3, 1).numpy())
        jxq = jnp.clip(jnp.round(jx * (1.0 / m.xscale.numpy())),
                       -127.0, 127.0).astype(jnp.int8)
        np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jxq), err_msg=name)
        p = c.padding[0]
        jacc = jax.lax.conv_general_dilated(
            jxq, jnp.asarray(k), c.stride, ((p, p), (p, p)),
            rhs_dilation=c.dilation,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jacc), err_msg=name)
        dilated += c.dilation[0] > 1
    assert dilated == 5       # layer 4's blocks 1 and 2, ASPP's 3x3s


# -------------------------------------------------------------------- CLIs
def write_seg_root(root, n=3, size=(70, 90), seed=0):
    """A VOC segmentation root: ``n`` JPEGs, colour ``SegmentationClass``
    PNGs with objects bordered in VOC's 255 boundary colour, and
    ``ImageSets/Segmentation/val.txt``. Returns the image paths."""
    rng = np.random.default_rng(seed)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    h, w = size
    ids = [f"{i:06d}" for i in range(n)]
    for i, img_id in enumerate(ids):
        cv2.imwrite(os.path.join(root, "JPEGImages", f"{img_id}.jpg"),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        mask = np.zeros((h, w, 3), np.uint8)
        mask[5:40, 10:60] = (224, 224, 192)
        mask[7:38, 12:58] = VOC_COLORMAP[1 + i % 20]
        cv2.imwrite(os.path.join(root, "SegmentationClass", f"{img_id}.png"),
                    mask[..., ::-1])
    with open(os.path.join(root, "ImageSets", "Segmentation", "val.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    return [os.path.join(root, "JPEGImages", f"{i}.jpg") for i in ids]


@pytest.fixture
def cli(monkeypatch, tmp_path):
    """The CLIs' registry lookup with DeepLab on ResNet-50 at a 65² crop,
    f32; runs in tmp_path."""
    from tpucv_torch import bench, evaluate, predict, serve
    from tpucv_torch.train import __main__ as train

    def small(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.log.tensorboard_on = False
        return _small(cfg), algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate, train, serve):
        monkeypatch.setattr(mod, "export_from_registry", small)
    return train, predict, evaluate, serve, bench


def test_clis_on_the_cpu(cli, tmp_path, monkeypatch, capsys):
    from tpucv_torch.trainer import base as tbase

    train, predict, evaluate, serve, bench = cli
    write_only(monkeypatch, tbase, keep=("final.ckpt",))
    train.main(["--model", "deeplabv3plus", "--device", "cpu",
                "--max-steps", "1", "--batch-size", "2"])
    ckpt = tmp_path / "saves" / "deeplabv3plus_voc_final.ckpt"
    assert ckpt.is_file()
    imgs = write_seg_root(str(tmp_path / "voc"))
    res = predict.main(["--model", "deeplabv3plus", "--device", "cpu",
                        "--ckpt", str(ckpt), "--src", imgs[0], "--dst",
                        str(tmp_path / "det")])
    assert len(res) == 1 and os.path.isfile(res[0]["saved"])
    assert res[0]["class_map"].shape == (CROP, CROP)
    q = predict.main(["--model", "deeplabv3plus", "--device", "cpu",
                      "--int8", "--src", *imgs[:2], "--dst",
                      str(tmp_path / "q")])
    assert len(q) == 2 and all(os.path.isfile(r["saved"]) for r in q)
    monkeypatch.setenv("TPUCV_VOC_ROOT", str(tmp_path / "voc"))
    out = evaluate.main(["--model", "deeplabv3plus", "--device", "cpu",
                         "--ckpt", str(ckpt), "--batch-size", "2"])
    assert 0 <= out["overall_acc"] <= 1 and len(out["per_class_iou"]) == NC
    q = evaluate.main(["--model", "deeplabv3plus", "--device", "cpu",
                       "--int8", "--batch-size", "2"])
    assert "mIoU" in q
    line = bench.main(["--model", "deeplabv3plus", "--device", "cpu",
                       "--small"])
    assert line["metric"] == \
        "deeplabv3plus_65_e2e_images_per_sec_per_cpu"
    assert (line["infer_batch"], line["train_batch"]) == (2, 2)
    assert line["value"] > 0 and line["train_step_ms"] > 0
    with pytest.raises(SystemExit, match="no serving path"):
        serve.build(["--model", "deeplabv3plus", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "segmentation map" in printed
    assert '"deeplabv3plus_65_e2e_images_per_sec_per_cpu"' in printed


def test_cli_refuses_a_missing_card(cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, predict, _, _, _ = cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--model", "deeplabv3plus", "--src", "x.jpg"])
