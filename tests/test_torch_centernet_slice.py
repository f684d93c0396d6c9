"""CenterNet as a slice: tpucv_torch's algorithm, trainer, int8 path and CLIs
against tpucv's, in f32 on the CPU, at CenterNet-DLA34 as shipped (nc 20,
head 256). Weights as in ``test_torch_centernet.py`` (the port's seeded
init with BatchNorm, conv biases and the upsample kernels drawn from a
numpy seed, carried into flax by ``import_centernet``). Held:

- ``build_loss`` (tpucv's jitted) on pixel GT boxes at 128²: total and
  terms within 1e-5 relative;
- ``make_infer_fn`` at 384, B=2, with the heatmap head sharpened
  (``heatmap.2``'s bias 0, its kernel x3000, so every score is 0 or 1 and
  ties order by flat index): valid and classes equal, boxes within 1e-3
  px, scores within 1e-5;
- 2 trainer steps against tpucv's on one small config (128², B=2, M=4,
  synthetic data, device augmentation and mosaic in both, f32): the loss
  and its terms within 1e-3 relative at both steps, the logged learning
  rates equal, ``LOSS_BATCH_SCALED`` False in both; after step 1 the
  running mean and variance of the dead outer ``project`` BatchNorm of
  level 3 and level 4 within 1e-5 of tpucv's and moved from their init,
  and those projects' weights equal to tpucv's and to the init (the port
  gives them no gradient, tpucv zeros; Adam with weight decay 0 leaves
  both alone);
- int8 (tpucv's ``test_quantize_ssd_and_centernet_models``: 64², nc 4):
  the port's quantized-conv count equal to tpucv's ``count_quantized``
  (every DLA and IDAUp conv + BN but the 3-channel stem, the dead
  projects included, and the three 3x3 head convs; the 1x1 heads and the
  transposed convs float); with tpucv's quant collection carried across,
  every quantized conv's int8 activation and int32 accumulators bit-equal
  to tpucv's quantize step and ``lax.conv_general_dilated`` on the same
  input;
- the train, predict and evaluate CLIs' ``main`` with ``--model centernet
  --device cpu`` (evaluate over a VOC root the test writes; predict and
  evaluate again with ``--int8``), ``serve --int8``'s build, and predict
  without ``--device cpu`` refusing a machine with no card.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_centernet import NC, numpy_sd, pair, port_model
from test_torch_trainer import Recorder
from test_torch_yolov7_slice import write_voc_root
from tpucv import quant as jq
from tpucv.algorithms.centernet import CenterNetA as JCenterNetA
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt.importer import import_centernet
from tpucv.models.centernet import CenterNet as JCenterNet
from tpucv.trainer import base as jbase
from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.models.centernet import CenterNet
from tpucv_torch.ops import int8_conv

torch.set_num_threads(1)
BOX_PX_TOL, SCORE_TOL = 1e-3, 1e-5
LOSS_REL = 1e-5
REL_STEP = 1e-3
BN_STAT_TOL = 1e-5
HM_GAIN = 3000.0
TERMS = ("loss", "hm_loss", "wh_loss", "off_loss")
DEAD = ("backbone.base.level_3.project", "backbone.base.level_4.project")


def sharpen(model):
    """The heatmap head's 1x1 conv: bias 0, kernel x3000."""
    with torch.no_grad():
        model.backbone.heatmap[2].weight.mul_(HM_GAIN)
        model.backbone.heatmap[2].bias.zero_()
    return model


def _configs():
    jcfg, _, _ = tpucv_export("centernet")
    tcfg, t_algo, _ = export_from_registry("centernet")
    for c in (jcfg, tcfg):
        c.train.mixed_precision = False
    return jcfg, tcfg, t_algo


def _small(cfg, size=128):
    cfg.dataset.input_size = cfg.arch.input_size = size
    return cfg


# -------------------------------------------------------------- algorithm
def test_build_loss_equals_tpucv():
    jcfg, tcfg, t_algo = _configs()
    j, t = JCenterNetA(_small(jcfg)), t_algo(_small(tcfg), device="cpu")
    assert j.out_hw == t.out_hw == (32, 32)
    rng = np.random.default_rng(20)
    raw = rng.normal(0, 2, (2, 32, 32, NC + 4)).astype(np.float32)
    cxy = rng.uniform(10, 118, (2, 6, 2))
    wh = rng.uniform(4, 90, (2, 6, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    batch = {"gt_bboxes": np.clip(boxes, 0, 128).astype(np.float32),
             "gt_labels": rng.integers(0, NC, (2, 6)).astype(np.int32),
             "gt_mask": rng.random((2, 6)) < 0.8}
    rt, rp = jax.jit(j.build_loss())(
        jnp.asarray(raw), {k: jnp.asarray(v) for k, v in batch.items()})
    gt, gp = t.build_loss()(
        torch.from_numpy(raw), {k: torch.from_numpy(v) for k, v in
                                batch.items()})
    assert float(gt) == pytest.approx(float(rt), rel=LOSS_REL)
    for k in rp:
        assert float(gp[k]) == pytest.approx(float(rp[k]), rel=LOSS_REL), k
    assert float(gp["wh_loss"]) > 0


def test_make_infer_fn_equals_tpucv():
    jcfg, tcfg, t_algo = _configs()
    model = sharpen(copy.deepcopy(pair()[2]))
    variables = import_centernet(numpy_sd(model))
    j = JCenterNetA(jcfg)
    t = t_algo(tcfg, device="cpu")
    imgs = np.random.default_rng(3).integers(0, 255, (2, 384, 384, 3),
                                             dtype=np.uint8)
    ref = [np.asarray(r) for r in j.make_infer_fn(j.build_model())(
        variables, jnp.asarray(imgs))]
    got = [g.numpy() for g in t.make_infer_fn()(model, torch.from_numpy(imgs))]
    assert got[0].shape == (2, 100, 4)
    assert got[3].sum() > 10 and np.all(got[1][got[3]] == 1.0)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[2][got[3]], ref[2][ref[3]])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got[0][got[3]], ref[0][ref[3]], rtol=0,
                               atol=BOX_PX_TOL)


# ---------------------------------------------------------------- trainer
def _shrink(cfg, root):
    _small(cfg)
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
    returns it, which also skips its ``jax.jit(model.init)``); each step's
    state is kept after step 1."""
    tcfg, _, t_cls = export_from_registry("centernet")
    t = t_cls(_shrink(tcfg, tmp_path / "port"), device="cpu")
    init = {k: v.clone() for k, v in t.model.state_dict().items()}
    tree = import_centernet(numpy_sd(t.model))
    monkeypatch.setattr(JCenterNetA, "init_variables",
                        lambda self, model=None, seed=0: tree)
    j_states, t_states = [], []
    j_make = jbase.make_train_step

    def j_recorded(*args, **kw):
        step = j_make(*args, **kw)

        def run(state, batch):
            state, metrics = step(state, batch)
            j_states.append(jax.tree_util.tree_map(
                lambda a: np.array(a, copy=True),
                {"params": state.params, "batch_stats": state.batch_stats}))
            return state, metrics
        return run

    monkeypatch.setattr(jbase, "make_train_step", j_recorded)
    t_make = t.build_train_step

    def t_recorded():
        step = t_make()

        def run(state, batch):
            state, metrics = step(state, batch)
            t_states.append({k: v.detach().clone() for k, v in
                             state.model.state_dict().items()})
            return state, metrics
        return run

    t.build_train_step = t_recorded
    jcfg, _, j_cls = tpucv_export("centernet")
    j = j_cls(_shrink(jcfg, tmp_path / "tpucv"))
    j.tb, t.tb = Recorder(), Recorder()
    j.train(max_steps=2)
    t.train(max_steps=2)
    assert t.LOSS_BATCH_SCALED is False is j.LOSS_BATCH_SCALED
    for k in TERMS:
        for step in (1, 2):
            np.testing.assert_allclose(
                t.tb.rows[f"train/{k}"][step], j.tb.rows[f"train/{k}"][step],
                rtol=REL_STEP, err_msg=f"{k} step {step}")
    for step in (1, 2):
        assert t.tb.rows["lr"][step] == pytest.approx(j.tb.rows["lr"][step],
                                                      rel=1e-6)
    assert len(j_states) == len(t_states) == 2
    ref, got = from_flax_variables(j_states[0]), t_states[0]
    for name in DEAD:
        for stat in ("running_mean", "running_var"):
            k = f"{name}.1.{stat}"
            assert not torch.equal(got[k], init[k]), k
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=0, atol=BN_STAT_TOL, err_msg=k)
        for k in (f"{name}.0.weight", f"{name}.1.weight", f"{name}.1.bias"):
            assert torch.equal(got[k], init[k]) and torch.equal(got[k],
                                                                ref[k]), k
    assert (tmp_path / "port" / "saves" / "centernet_voc_final.ckpt").is_file()


# ------------------------------------------------------------------- int8
@functools.lru_cache(maxsize=None)
def _quantized():
    """tpucv's and the port's own PTQ of the same CenterNet (nc 4) on one
    64² image."""
    model = port_model(nc=4)
    variables = import_centernet(numpy_sd(model))
    x = np.random.default_rng(11).random((1, 64, 64, 3), np.float32)
    qv = jq.quantize_for_inference(JCenterNet(num_classes=4), variables,
                                   [jnp.asarray(x)])
    own = quant.quantize_for_inference(model, [torch.from_numpy(x)])
    return x, qv, own


def _quant_entries(tree, path=()):
    """{(scope, conv): {key: value}} of a tpucv quant collection."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_quant_entries(v, path + (k,)))
        else:
            conv, key = k.split("::")
            out.setdefault((path, conv), {})[key] = v
    return out


def test_int8_counts_equal_tpucv():
    _, qv, own = _quantized()
    n = jq.count_quantized(qv["quant"])
    assert n > 20
    assert quant.count_quantized(own) == n
    names = {name for name, m in quant.hooked(own) if m.qweight is not None}
    assert "backbone.base.base_layer.0" not in names      # 3-channel stem
    assert {f"{d}.0" for d in DEAD} <= names
    assert {f"backbone.{h}.0" for h in ("heatmap", "wh", "reg")} <= names
    assert not any(".up_" in n or n.endswith(".2") for n in names)
    # a quantized state_dict loads into a float-built model, quantized
    fresh = CenterNet(4)
    fresh.load_state_dict(own.state_dict(), strict=True)
    assert quant.count_quantized(fresh) == n


def test_int8_accumulators_bit_equal_tpucv():
    """tpucv's quant collection carried across; the same input into each
    quantized conv for both engines."""
    x, qv, _ = _quantized()
    q = CenterNet(4)
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
    by_kernel = {np.asarray(e["qkernel"]).tobytes(): e
                 for e in _quant_entries(qv["quant"]).values()}
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
        jxq = jnp.clip(jnp.round(jx * (1.0 / e["xscale"])),
                       -127.0, 127.0).astype(jnp.int8)
        np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jxq), err_msg=name)
        p = c.padding[0]
        jacc = jax.lax.conv_general_dilated(
            jxq, e["qkernel"], c.stride, ((p, p), (p, p)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jacc), err_msg=name)


# -------------------------------------------------------------------- CLIs
@pytest.fixture
def cli(monkeypatch, tmp_path):
    """The CLIs' registry lookup as shipped but f32; runs in tmp_path."""
    from tpucv_torch import evaluate, predict, serve
    from tpucv_torch.train import __main__ as train

    def f32(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.train.mixed_precision = False
        cfg.log.tensorboard_on = False
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate, train, serve):
        monkeypatch.setattr(mod, "export_from_registry", f32)
    return train, predict, evaluate, serve


def test_clis_on_the_cpu(cli, tmp_path, monkeypatch, capsys):
    train, predict, evaluate, serve = cli
    train.main(["--model", "centernet", "--device", "cpu", "--max-steps",
                "1", "--batch-size", "2"])
    ckpt = tmp_path / "saves" / "centernet_voc_final.ckpt"
    assert ckpt.is_file()
    imgs = write_voc_root(str(tmp_path / "voc"), n=2, size=(240, 320))
    res = predict.main(["--model", "centernet", "--device", "cpu", "--ckpt",
                        str(ckpt), "--src", imgs[0], "--dst",
                        str(tmp_path / "det")])
    assert len(res) == 1 and os.path.isfile(res[0]["saved"])
    q = predict.main(["--model", "centernet", "--device", "cpu", "--int8",
                      "--src", *imgs[:2], "--dst", str(tmp_path / "q")])
    assert len(q) == 2 and all(os.path.isfile(r["saved"]) for r in q)
    monkeypatch.setenv("TPUCV_VOC_ROOT", str(tmp_path / "voc"))
    out = evaluate.main(["--model", "centernet", "--device", "cpu", "--ckpt",
                         str(ckpt), "--batch-size", "2"])
    assert "mAP" in out and "coco" in out
    q = evaluate.main(["--model", "centernet", "--device", "cpu", "--int8",
                       "--batch-size", "2"])
    assert "mAP" in q
    server = serve.build(["--model", "centernet", "--device", "cpu", "--host",
                          "127.0.0.1", "--port", "0", "--batch", "1",
                          "--int8", "--calib",
                          str(tmp_path / "voc" / "JPEGImages")])
    try:
        assert quant.count_quantized(server.batcher.model) == \
            quant.count_quantized(_quantized()[2])
    finally:
        server.batcher.stop()
        server.server_close()
    assert "centernet" in capsys.readouterr().out


def test_cli_refuses_a_missing_card(cli):
    """By default the CLIs run on the card; with none they raise rather
    than move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, predict, _, _ = cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--model", "centernet", "--src", "x.jpg"])
