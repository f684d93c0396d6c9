"""The classification slice, ``vit_cls`` and ``yolo8_cls``: tpucv_torch's
network, data, loss, algorithm, trainer and CLIs against tpucv's, in f32
on the CPU. Weights come from tpucv's init (``jax.jit(model.init)``; for
YOLOv8-cls its BatchNorm drawn from a numpy seed, ``randomize_bn``),
carried by ``from_flax_variables`` with ``strict=True``. Held:

- ``Yolo8(head="classify")`` at scale n, 64², nc 4: layers 0-8 and
  ``model.9`` only (ultralytics' yolov8-cls keys), the eval and the
  train-mode (batch statistics) logits within FWD_REL (1e-4) of the
  largest |logit|, the running statistics after the train-mode forward
  within 1e-5;
- the data: ``SyntheticClsIndex`` and ``ImageFolderIndex`` (JPEGs and a
  PNG, classes pinned to the train split) equal to tpucv's; the train
  crop and flip, keyed by (epoch, i), byte-equal over two epochs; the
  loader's collated batches equal;
- ``build_loss``: the label-smoothed CE within LOSS_REL (1e-5) relative
  of tpucv's jitted loss, ``acc`` equal;
- ``make_infer_fn``: the softmax within PROB_ATOL (1e-6) of tpucv's;
  ``evaluate``'s top-1 / top-5 on a fake infer (tpucv's own case) and on
  both engines' real models equal (BatchNorm drawn from a seed,
  ``_spread``), after checking that no image's ranking holds a near-tie
  within 2 PROB_ATOL among its top six;
  ``predict`` printing the same top-k labels;
- ``evaluate_map`` is ``{}``; ``--int8`` refused by the predict and
  evaluate CLIs, ``serve`` refusing both names; the registry and
  ``check.py`` taking both names with tpucv's config values;
- three trainer steps of each family from the same init on the same
  synthetic batches: loss within STEP_REL (1e-5) relative of tpucv's
  (measured 1.0-1.3e-7 for ViT, 0.3-1.8e-6 for YOLOv8n-cls with
  BatchNorm at the identity), ``acc`` and the learning rates equal;
- the train, predict and evaluate CLIs' ``main`` with ``--device cpu``
  (evaluate over a folder-per-class root the test writes).
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import Recorder
from test_torch_yolov8 import randomize_bn
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.check import MODELS as TPUCV_MODELS
from tpucv.data import classification_dataset as jdata
from tpucv.data.loader import Loader as JLoader
from tpucv.models.yolov8 import Yolo8 as FlaxYolo8
from tpucv_torch.builder import export_from_registry
from tpucv_torch.check import MODELS, check_model_name
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.data import classification_dataset as tdata
from tpucv_torch.data.loader import Loader
from tpucv_torch.models.yolov8 import Yolo8

torch.set_num_threads(1)
FWD_REL = 1e-4
LOSS_REL = 1e-5
STEP_REL = 1e-5
PROB_ATOL = 1e-6
NAMES = ("vit_cls", "yolo8_cls")


def _tiny(cfg, name):
    """tpucv's own test sizes (tests/test_classification.py,
    tests/test_yolov8_cls.py): ViT patch 8, dim 32, depth 1, heads 2 at
    32²; YOLOv8n-cls at 64²; nc 4, B=4, f32."""
    if name == "vit_cls":
        cfg.dataset.input_size = 32
        cfg.arch.patch, cfg.arch.dim, cfg.arch.depth, cfg.arch.heads = \
            8, 32, 1, 2
    else:
        cfg.dataset.input_size = 64
    cfg.n_classes = 4
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(name):
    """tpucv's algorithm and variables (seed 0; YOLOv8-cls's BatchNorm
    randomised), the port's algorithm and its model with them."""
    jcfg, j_cls, _ = tpucv_export(name)
    tcfg, t_cls, _ = export_from_registry(name)
    j = j_cls(_tiny(jcfg, name))
    t = t_cls(_tiny(tcfg, name), device="cpu")
    variables = j.init_variables()
    if "batch_stats" in variables:
        rng = np.random.default_rng(0)
        variables = {"params": randomize_bn(variables["params"], rng),
                     "batch_stats": randomize_bn(variables["batch_stats"],
                                                 rng)}
    model = t.init_variables()
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return j, variables, t, model


def _u8(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                dtype=np.uint8)


# ---------------------------------------------------------------- network
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_yolo8_classify_equals_tpucv(train):
    fm = FlaxYolo8(scale="n", nc=4, head="classify")
    v = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(1)
    variables = {"params": randomize_bn(v["params"], rng),
                 "batch_stats": randomize_bn(v["batch_stats"], rng)}
    assert set(variables["params"]) == {f"b{i}" for i in range(9)} | {
        "classify"}
    model = Yolo8("n", nc=4, head="classify")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    assert len(model.model) == 10
    keys = model.state_dict()
    assert {"model.9.conv.conv.weight", "model.9.conv.bn.running_var",
            "model.9.linear.weight", "model.9.linear.bias"} <= set(keys)
    assert not any(k.startswith(("model.10.", "model.22.")) for k in keys)
    assert keys["model.9.linear.weight"].shape == (4, 1280)
    x = np.random.default_rng(2).random((2, 64, 64, 3), np.float32)
    if train:
        ref, upd = fm.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        model.train()
    else:
        ref = fm.apply(variables, jnp.asarray(x))
        model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, 4)
    assert np.abs(got - ref).max() <= FWD_REL * np.abs(ref).max()
    if train:
        sd = from_flax_variables({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]})
        for k, want in sd.items():
            if "running" in k:
                assert float((keys[k] - want).abs().max()) <= 1e-5, k


# ------------------------------------------------------------------- data
def write_cls_root(root, classes=("cat", "dog", "eel"), n=3, seed=0):
    """A folder-per-class tree: ``n`` JPEGs a class in train and val (one
    PNG in each), of assorted sizes; val lacks the last class."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for c in classes[: None if split == "train" else -1]:
            d = os.path.join(root, split, c)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                h, w = rng.integers(40, 90, 2)
                img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                ext = ".png" if i == 0 else ".jpg"
                cv2.imwrite(os.path.join(d, f"{i}{ext}"), img)
    return root


def test_synthetic_index_equals_tpucv():
    for seed in (0, 1):
        ji = jdata.SyntheticClsIndex(12, 48, 10, seed=seed)
        ti = tdata.SyntheticClsIndex(12, 48, 10, seed=seed)
        assert len(ti) == len(ji) and ti.classes == ji.classes
        for i in range(12):
            (a, la), (b, lb) = ji[i], ti[i]
            assert la == lb and np.array_equal(a, b)


def test_folder_index_and_samples_equal_tpucv(tmp_path):
    root = write_cls_root(str(tmp_path))
    for split in ("train", "val"):
        classes = None if split == "train" else \
            jdata.ImageFolderIndex(root, "train").classes
        ji = jdata.ImageFolderIndex(root, split, classes=classes)
        ti = tdata.ImageFolderIndex(root, split, classes=classes)
        assert ti.classes == ji.classes and ti.samples == ji.samples
    assert ti.classes == ["cat", "dog", "eel"] and len(ti) == 6
    for train in (True, False):
        jd = jdata.ClassificationDataset(
            jdata.ImageFolderIndex(root, "train"), 32, train=train)
        td = tdata.ClassificationDataset(
            tdata.ImageFolderIndex(root, "train"), 32, train=train)
        for epoch in (0, 1):
            jd.set_epoch(epoch)
            td.set_epoch(epoch)
            for i in range(len(td)):
                a, b = jd[i], td[i]
                assert b["images"].dtype == np.uint8
                assert b["images"].shape == (32, 32, 3)
                assert np.array_equal(a["images"], b["images"]), (epoch, i)
                assert a["labels"] == b["labels"]


def test_loader_batches_equal_tpucv():
    ji = jdata.SyntheticClsIndex(16, 48, 4, seed=0)
    ti = tdata.SyntheticClsIndex(16, 48, 4, seed=0)
    jl = JLoader(jdata.ClassificationDataset(ji, 32, train=True), 4,
                 shuffle=True, collate=jdata.classification_collate)
    tl = Loader(tdata.ClassificationDataset(ti, 32, train=True), 4,
                shuffle=True, collate=tdata.classification_collate)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for a, b in zip(jl, tl):
            assert b["images"].shape == (4, 32, 32, 3)
            assert b["labels"].dtype == np.int32
            for k in ("images", "labels"):
                assert np.array_equal(a[k], b[k]), (epoch, k)


# -------------------------------------------------------------- algorithm
@pytest.mark.parametrize("case", ["random", "confident"])
def test_loss_and_acc_equal_tpucv(case):
    j, _, t, _ = _pair("vit_cls")
    rng = np.random.default_rng(3)
    if case == "random":
        logits = rng.normal(0, 3, (16, 4)).astype(np.float32)
        labels = rng.integers(0, 4, 16).astype(np.int32)
    else:                                     # tpucv's own case
        logits = np.array([[10.0, 0, 0, 0], [0, 10.0, 0, 0]], np.float32)
        labels = np.array([0, 1], np.int32)
    rl, rm = jax.jit(j.build_loss())(jnp.asarray(logits),
                                     {"labels": jnp.asarray(labels)})
    gl, gm = t.build_loss()(torch.from_numpy(logits),
                            {"labels": torch.from_numpy(labels)})
    assert sorted(gm) == sorted(rm) == ["acc"]
    assert float(gl) == pytest.approx(float(rl), rel=LOSS_REL)
    assert float(gm["acc"]) == float(rm["acc"])
    if case == "confident":
        assert float(gm["acc"]) == 1.0 and 0.0 < float(gl) < 2.0


@pytest.mark.parametrize("name", NAMES)
def test_make_infer_fn_softmax_equals_tpucv(name):
    j, variables, t, model = _pair(name)
    imgs = _u8(3, j.input_size, seed=4)
    ref = np.asarray(j.make_infer_fn()(variables, jnp.asarray(imgs)))
    got = t.make_infer_fn()(model, torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
    assert np.abs(got.numpy() - ref).max() <= PROB_ATOL


def test_evaluate_top1_top5_on_a_fake_infer():
    """tpucv's own case (tests/test_classification.py): class (j mod 4)
    right for even j only; nc 4, so top-5 holds every label."""
    _, t = _with_classes("vit_cls", 4)
    index = tdata.SyntheticClsIndex(8, 32, 4, seed=0)

    def fake_infer(model, imgs):
        n = imgs.shape[0]
        probs = torch.full((n, 4), 0.01)
        for j in range(n):
            probs[j, (j % 4) if j % 2 == 0 else (j + 1) % 4] = 0.9
        return probs

    t.make_infer_fn = lambda *a, **k: fake_infer
    res = t.evaluate(None, index, batch_size=8, verbose=False)
    assert res == {"top1": 0.5, "top5": 1.0}


def _clear_margins(probs, k):
    """The smallest gap between consecutive sorted probabilities over
    ranks 0..k (rank k is the first one outside the top k)."""
    s = -np.sort(-probs, axis=-1)[:, :k + 1]
    return float(np.diff(-s, axis=-1).min())


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_equals_tpucv(name, monkeypatch):
    """10 synthetic images at B=4 (the last batch zero-filled); a 6-class
    head so that top-5 is a real cut."""
    j, variables, t, model = _pair(name)
    index = tdata.SyntheticClsIndex(10, j.input_size, 6, seed=2)
    j6, t6 = _with_classes(name, 6)
    v6 = _spread(j6.init_variables())
    m6 = t6.init_variables()
    m6.load_state_dict(from_flax_variables(v6), strict=True)
    imgs = np.stack([index[i][0] for i in range(10)])
    probs = np.asarray(j6.make_infer_fn()(v6, jnp.asarray(imgs)))
    assert _clear_margins(probs, 5) > 2 * PROB_ATOL
    ref = j6.evaluate(v6, index, batch_size=4, verbose=False)
    got = t6.evaluate(m6, index, batch_size=4, verbose=False)
    assert got == ref and 0 < got["top5"] < 1


def _spread(variables):
    """A numpy copy of ``variables`` with BatchNorm drawn from a seed
    (``randomize_bn``): with BatchNorm at the identity YOLOv8n-cls's
    probabilities sit within 1e-6 of 1/nc, where the two engines' f32
    rounding reorders them; drawn, they part by more than 1e-3."""
    rng = np.random.default_rng(7)
    return {k: randomize_bn(v, rng) for k, v in variables.items()}


def _with_classes(name, nc):
    jcfg, j_cls, _ = tpucv_export(name)
    tcfg, t_cls, _ = export_from_registry(name)
    jcfg, tcfg = _tiny(jcfg, name), _tiny(tcfg, name)
    jcfg.n_classes = tcfg.n_classes = nc
    return j_cls(jcfg), t_cls(tcfg, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_predict_prints_the_top_k_labels(name, tmp_path, capsys):
    j, variables, t, model = _pair(name)
    path = str(tmp_path / "img.jpg")
    cv2.imwrite(path, _u8(1, 70, seed=5)[0, :, :50])
    ref = j.predict(variables, path)
    jprinted = capsys.readouterr().out
    got = t.predict(model, path, save_dir=str(tmp_path / "out"))
    printed = capsys.readouterr().out
    assert got["boxes"].shape == (0, 4) and got["saved"] is None
    assert len(got["labels"]) == 4 and got["scores"].shape == (4,)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=PROB_ATOL)
    if _clear_margins(ref["scores"][None], 3) > 2 * PROB_ATOL:
        assert got["labels"] == ref["labels"]
        assert printed == jprinted
    for label in got["labels"]:
        assert f"{label:>12s}: " in printed


# -------------------------------------------------------------- refusals
def test_registry_and_check_take_both_names():
    assert set(MODELS) == set(TPUCV_MODELS)
    for name, algo, trainer in [("vit_cls", "VitClassification",
                                 "VitClsTrainer"),
                                ("yolo8_cls", "YOLOv8Cls",
                                 "Yolo8ClsTrainer")]:
        check_model_name(name)
        cfg, a, tr = export_from_registry(name)
        jcfg, _, _ = tpucv_export(name)
        assert (cfg.model_name, a.__name__, tr.__name__) == (name, algo,
                                                              trainer)
        assert vars(cfg.arch) == vars(jcfg.arch)
        assert cfg.loss.label_smoothing == jcfg.loss.label_smoothing == 0.1
        assert (cfg.dataset.input_size, cfg.num_classes,
                cfg.train.batch_size, cfg.train.mixed_precision) == (
            jcfg.dataset.input_size, jcfg.num_classes,
            jcfg.train.batch_size, jcfg.train.mixed_precision) == (
            224, 10, 16, True)
        assert vars(cfg.optimizer) == vars(jcfg.optimizer)
        assert not hasattr(a, "quantize_variables")
        assert not hasattr(a, "_batched_detections")
    assert issubclass(export_from_registry("yolo8_cls")[1],
                      export_from_registry("vit_cls")[1])


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_map_is_empty(name, tmp_path):
    cfg, _, cls = export_from_registry(name)
    cfg = _tiny(cfg, name)
    cfg.train.eval_map = True
    cfg.train.save_path = str(tmp_path / "saves")
    cfg.log.root = str(tmp_path / "log")
    trainer = cls(cfg, device="cpu")
    assert trainer.val_index is not None
    assert trainer.evaluate_map(trainer.state) == {}
    assert trainer.LOSS_BATCH_SCALED is False


@pytest.mark.parametrize("name", NAMES)
def test_int8_and_serve_refused(name):
    from tpucv_torch import evaluate, predict, serve

    with pytest.raises(SystemExit, match=f"not supported for {name}"):
        predict.main(["--model", name, "--device", "cpu", "--int8",
                      "--src", "x.jpg"])
    with pytest.raises(SystemExit, match=f"not supported for {name}"):
        evaluate.main(["--model", name, "--device", "cpu", "--int8"])
    with pytest.raises(SystemExit, match="segmentation or classification"):
        serve.build(["--model", name, "--device", "cpu"])


def test_folder_tree_class_count_must_match(tmp_path, monkeypatch):
    root = write_cls_root(str(tmp_path))
    monkeypatch.setenv("TPUCV_CLS_ROOT", root)
    _, t = _with_classes("vit_cls", 4)
    with pytest.raises(SystemExit, match="3 classes"):
        t.build_eval_index("val")
    _, t = _with_classes("vit_cls", 3)
    index = t.build_eval_index("val")
    assert t.class_names == ["cat", "dog", "eel"] and len(index) == 6


# ---------------------------------------------------------------- trainer
@pytest.mark.parametrize("name", NAMES)
def test_trainer_steps_equal_tpucv(name, tmp_path):
    """Both trainers from tpucv's seed-0 init, BatchNorm drawn from a seed
    (``_spread``: ``acc`` is an argmax, and at BatchNorm's identity the
    logits tie within rounding), carried into the port's model in place,
    so Adam holds the same tensors; 3 steps on the synthetic set's first
    three batches of 4."""
    jcfg, _, j_cls = tpucv_export(name)
    tcfg, _, t_cls = export_from_registry(name)
    for cfg, sub in ((jcfg, "tpucv"), (tcfg, "port")):
        _tiny(cfg, name)
        cfg.train.save_path = str(tmp_path / sub / "saves")
        cfg.log.root = str(tmp_path / sub / "log")
    j = j_cls(jcfg)
    t = t_cls(tcfg, device="cpu")
    init = _spread({"params": j.init_params,
                    "batch_stats": j.init_batch_stats})
    j.init_params, j.init_batch_stats = init["params"], init["batch_stats"]
    t.model.load_state_dict(from_flax_variables(init), strict=True)
    j.tb, t.tb = Recorder(), Recorder()
    j.train(max_steps=3)
    t.train(max_steps=3)
    for step in (1, 2, 3):
        assert t.tb.rows["train/loss"][step] == pytest.approx(
            j.tb.rows["train/loss"][step], rel=STEP_REL), step
        assert t.tb.rows["train/acc"][step] == j.tb.rows["train/acc"][step]
        assert t.tb.rows["lr"][step] == pytest.approx(j.tb.rows["lr"][step],
                                                      rel=1e-6)
    val = t.evaluate_loop(t.state)
    assert sorted(val) == ["val_acc", "val_loss"]
    assert np.isfinite(val["val_loss"]) and 0 <= val["val_acc"] <= 1


# ------------------------------------------------------------------- CLIs
@pytest.fixture
def cli(monkeypatch, tmp_path):
    """The CLIs' registry lookup at the tiny sizes; runs in tmp_path."""
    from tpucv_torch import evaluate, predict
    from tpucv_torch.train import __main__ as train

    def small(name):
        cfg, algo, cls = export_from_registry(name)
        return _tiny(cfg, name), algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate, train):
        monkeypatch.setattr(mod, "export_from_registry", small)
    return train, predict, evaluate


@pytest.mark.parametrize("name", NAMES)
def test_clis_on_the_cpu(name, cli, tmp_path, monkeypatch, capsys):
    train, predict, evaluate = cli
    state = train.main(["--model", name, "--device", "cpu", "--max-steps",
                        "2", "--batch-size", "4"])
    assert state.step == 2
    ckpt = tmp_path / "saves" / f"{name}_folder_final.ckpt"
    assert ckpt.is_file()
    root = write_cls_root(str(tmp_path / "cls"),
                          classes=("a", "b", "c", "d"))
    img = os.path.join(root, "val", "a", "1.jpg")
    res = predict.main(["--model", name, "--device", "cpu", "--ckpt",
                        str(ckpt), "--src", img])
    assert len(res) == 1 and len(res[0]["labels"]) == 4
    printed = capsys.readouterr().out
    assert f"{img}: top: {', '.join(res[0]['labels'][:3])} -> None" in \
        printed
    monkeypatch.setenv("TPUCV_CLS_ROOT", root)
    out = evaluate.main(["--model", name, "--device", "cpu", "--ckpt",
                         str(ckpt), "--batch-size", "4"])
    assert set(out) == {"top1", "top5"} and out["top5"] == 1.0
    assert "(9 images)" in capsys.readouterr().out
