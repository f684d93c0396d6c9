"""SSD as a slice: tpucv_torch's algorithm, trainer, int8 path and CLIs
against tpucv's, in f32 on the CPU, at SSD300 (nc 21) as shipped. Weights
as in ``test_torch_ssd.py`` (the port's seeded init with BatchNorm and
conv biases drawn from a numpy seed, carried into flax by
``import_ssd``). Held:

- ``build_loss`` (tpucv's jitted, its priors a constant of the program)
  on pixel GT boxes: total and terms within 1e-5 relative, num_pos equal
  (XLA compiles the division by the input size as the f32 reciprocal's
  product, as the port computes it);
- ``make_infer_fn`` at 300, B=2, with the conf heads sharpened (biases 0,
  kernels x3000, so every score is 0 or 1 and ties order by flat index):
  valid and classes equal, boxes within 1e-3 px, scores within 1e-5
  (``test_torch_predict.py``'s bounds);
- 2 trainer steps against tpucv's on one small config (300², B=2, M=4,
  synthetic data, device augmentation and mosaic in both, f32): the loss
  and its terms within 1e-3 relative at both steps (the YOLOv7 slice's
  bound), num_pos equal at step 1, the logged learning rates equal;
  ``LOSS_BATCH_SCALED`` False, as tpucv's trainer has it;
- int8 (tpucv's ``test_quantize_ssd_and_centernet_models``): 14 quantized
  convs in both (13 VGG convs less the 3-channel stem, conv6 and conv7),
  the extras and the heads float; the bias fold of a biased conv + BN pair
  and of a biased conv without BN bit-equal to tpucv's
  ``_quantize_convbn``; with tpucv's quant collection carried across,
  every quantized conv's int8 activation and int32 accumulators bit-equal
  to tpucv's quantize step and ``lax.conv_general_dilated`` (conv6's
  dilation 6 included) on the same input (the backbone at 64²);
- the train, predict and evaluate CLIs' ``main`` with ``--model ssd
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

from test_torch_ssd import NC, numpy_sd, pair
from test_torch_trainer import Recorder
from test_torch_yolov7_slice import write_voc_root
from tpucv import quant as jq
from tpucv.algorithms.ssd import Ssd as JSsd
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt.importer import import_ssd
from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.models.ssd import SSD
from tpucv_torch.ops import int8_conv

torch.set_num_threads(1)
BOX_PX_TOL, SCORE_TOL = 1e-3, 1e-5
LOSS_REL = 1e-5
REL_STEP = 1e-3
CLS_GAIN = 3000.0
N_QUANT = 14


def sharpen(model):
    """The conf heads: biases 0, kernels x3000."""
    with torch.no_grad():
        for conf in model.confs:
            conf.weight.mul_(CLS_GAIN)
            conf.bias.zero_()
    return model


def _configs(mixed=False):
    jcfg, _, _ = tpucv_export("ssd")
    tcfg, t_algo, _ = export_from_registry("ssd")
    for c in (jcfg, tcfg):
        c.train.mixed_precision = mixed
    return jcfg, tcfg, t_algo


# -------------------------------------------------------------- algorithm
def test_build_loss_equals_tpucv():
    jcfg, tcfg, t_algo = _configs()
    j, t = JSsd(jcfg), t_algo(tcfg, device="cpu")
    A = t.priors.shape[0]
    rng = np.random.default_rng(20)
    loc = rng.normal(0, 1, (2, A, 4)).astype(np.float32)
    conf = rng.normal(0, 0.5, (2, A, NC)).astype(np.float32)
    conf[..., 0] = rng.permutation(np.linspace(1.0, 7.0, 2 * A,
                                               dtype=np.float32)).reshape(2, A)
    cxy = rng.uniform(10, 290, (2, 6, 2))
    wh = rng.uniform(8, 200, (2, 6, 2))
    batch = {"gt_bboxes": np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2],
                                                 -1), 0, 300).astype(np.float32),
             "gt_labels": rng.integers(0, 20, (2, 6)).astype(np.int32),
             "gt_mask": rng.random((2, 6)) < 0.8}
    rt, rp = jax.jit(j.build_loss())(
        (jnp.asarray(loc), jnp.asarray(conf)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    gt, gp = t.build_loss()(
        (torch.from_numpy(loc), torch.from_numpy(conf)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(gp["num_pos"]) == float(rp["num_pos"]) > 0
    assert float(gt) == pytest.approx(float(rt), rel=LOSS_REL)
    for k in ("loc_loss", "conf_loss"):
        assert float(gp[k]) == pytest.approx(float(rp[k]), rel=LOSS_REL), k
    assert t.priors.device.type == "cpu" and t.priors.shape == (8732, 4)


def test_make_infer_fn_equals_tpucv():
    jcfg, tcfg, t_algo = _configs()
    model = sharpen(copy.deepcopy(pair(300)[2]))
    variables = import_ssd(numpy_sd(model))
    j = JSsd(jcfg)
    t = t_algo(tcfg, device="cpu")
    imgs = np.random.default_rng(3).integers(0, 255, (2, 300, 300, 3),
                                             dtype=np.uint8)
    ref = [np.asarray(r) for r in j.make_infer_fn(j.build_model())(
        variables, jnp.asarray(imgs))]
    got = [g.numpy() for g in t.make_infer_fn()(model, torch.from_numpy(imgs))]
    assert got[3].sum() > 10 and np.all(got[1][got[3]] == 1.0)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[2][got[3]], ref[2][ref[3]])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=BOX_PX_TOL)


# ---------------------------------------------------------------- trainer
def _shrink(cfg, root):
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
    returns it, which also skips its ``jax.jit(model.init)``)."""
    tcfg, _, t_cls = export_from_registry("ssd")
    t = t_cls(_shrink(tcfg, tmp_path / "port"), device="cpu")
    tree = import_ssd(numpy_sd(t.model))
    monkeypatch.setattr(JSsd, "init_variables",
                        lambda self, model=None, seed=0: tree)
    jcfg, _, j_cls = tpucv_export("ssd")
    j = j_cls(_shrink(jcfg, tmp_path / "tpucv"))
    j.tb, t.tb = Recorder(), Recorder()
    j.train(max_steps=2)
    t.train(max_steps=2)
    assert t.LOSS_BATCH_SCALED is False is j.LOSS_BATCH_SCALED
    for k in ("loss", "loc_loss", "conf_loss"):
        for step in (1, 2):
            np.testing.assert_allclose(
                t.tb.rows[f"train/{k}"][step], j.tb.rows[f"train/{k}"][step],
                rtol=REL_STEP, err_msg=f"{k} step {step}")
    assert t.tb.rows["train/num_pos"][1] == j.tb.rows["train/num_pos"][1] > 0
    for step in (1, 2):
        assert t.tb.rows["lr"][step] == pytest.approx(j.tb.rows["lr"][step],
                                                      rel=1e-6)
    assert (tmp_path / "port" / "saves" / "ssd_voc_final.ckpt").is_file()


# ------------------------------------------------------------------- int8
@functools.lru_cache(maxsize=None)
def _quantized():
    """tpucv's and the port's own PTQ of the shared SSD300 on one image."""
    jm, variables, model = pair(300)
    x = np.random.default_rng(8).random((1, 300, 300, 3), np.float32)
    qv = jq.quantize_for_inference(jm, variables, [jnp.asarray(x)])
    own = quant.quantize_for_inference(model, [torch.from_numpy(x)])
    return x, qv, own


def test_int8_counts_and_float_extras_and_heads():
    _, qv, own = _quantized()
    assert jq.count_quantized(qv["quant"]) == N_QUANT
    assert quant.count_quantized(own) == N_QUANT
    assert quant.count_quantized(pair(300)[2]) == 0
    names = [n for n, m in quant.hooked(own) if m.qweight is not None]
    assert names == [f"backbone.layers.{i}" for i in
                     (3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40, 44, 46)]
    assert {k.split("::")[0] for k in qv["quant"]} == {
        *(f"vgg{k}_conv" for k in range(1, 13)), "conv6", "conv7"}
    # a quantized state_dict loads into a float-built model, quantized
    fresh = SSD(NC, 300)
    fresh.load_state_dict(own.state_dict(), strict=True)
    assert quant.count_quantized(fresh) == N_QUANT


@pytest.mark.parametrize("with_bn", [True, False])
def test_int8_bias_fold_bit_equal_tpucv(with_bn):
    """A biased conv + BN pair (VGG) and a biased conv alone (conv6 / conv7,
    tpucv's ``NO_BN``): the same weights and absmax give tpucv's entries
    bit for bit."""
    model = pair(300)[2]
    conv = model.backbone.layers[10 if with_bn else 44]
    bn = conv.bn
    assert (bn is not None) == with_bn
    absmax, eps = 3.7, float(np.float32(1e-5))
    cp = {"kernel": np.transpose(conv.weight.detach().numpy(), (2, 3, 1, 0)),
          "bias": conv.bias.detach().numpy()}
    bnp = bnb = {}
    if with_bn:
        bnp = {"scale": bn.weight.detach().numpy(),
               "bias": bn.bias.detach().numpy()}
        bnb = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    ref = jq._quantize_convbn(cp, bnp, bnb, absmax, 8, eps)
    bn_args = ((None,) * 4 if bn is None else
               (bnp["scale"], bnp["bias"], bnb["mean"], bnb["var"]))
    got = quant.quantize_convbn(conv.weight.detach().numpy(), *bn_args, eps,
                                absmax, conv_bias=cp["bias"])
    want = (np.transpose(np.asarray(ref["qkernel"]), (3, 2, 0, 1)),
            ref["xscale"], ref["scale"], ref["bias"])
    for name, g, w in zip(("qkernel", "xscale", "scale", "bias"), got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_int8_accumulators_bit_equal_tpucv():
    """tpucv's quant collection carried across; the same input into each
    quantized conv for both engines, through the backbone at 64² (all 14
    are there)."""
    x, qv, _ = _quantized()
    q = SSD(NC, 300)
    q.load_state_dict(from_flax_variables(qv), strict=True)
    q.eval()
    assert quant.count_quantized(q) == N_QUANT
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: seen.append((name, mod, inp[0])))
        for name, m in quant.hooked(q) if m.qweight is not None]
    # every quantized conv is in the backbone, which takes any size: 64²
    xs = torch.from_numpy(x[:, :64, :64]).permute(0, 3, 1, 2)
    try:
        with torch.no_grad():
            q.backbone(xs)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == N_QUANT
    by_kernel = {np.asarray(qv["quant"][f"{k}::qkernel"]).tobytes(): k
                 for k in {n.split("::")[0] for n in qv["quant"]}}
    for name, m, xi in seen:
        c = m.conv
        xq = quant.quantize_activation(xi, m.xscale)
        acc = int8_conv.conv_plain(xq, m.qweight, c.kernel_size, c.stride,
                                   c.padding, c.dilation, c.groups)
        hwio = m.qweight.numpy().reshape(
            c.out_channels, c.kernel_size[0], c.kernel_size[1],
            -1).transpose(1, 2, 3, 0)
        key = by_kernel[hwio.tobytes()]
        e = {k: qv["quant"][f"{key}::{k}"] for k in ("qkernel", "xscale")}
        jx = jnp.asarray(xi.permute(0, 2, 3, 1).numpy())
        jxq = jnp.clip(jnp.round(jx * (1.0 / e["xscale"])),
                       -127.0, 127.0).astype(jnp.int8)
        np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jxq), err_msg=name)
        p = c.padding[0]
        jacc = jax.lax.conv_general_dilated(
            jxq, e["qkernel"], c.stride, ((p, p), (p, p)),
            rhs_dilation=c.dilation,
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
    train.main(["--model", "ssd", "--device", "cpu", "--max-steps", "1",
                "--batch-size", "2"])
    ckpt = tmp_path / "saves" / "ssd_voc_final.ckpt"
    assert ckpt.is_file()
    imgs = write_voc_root(str(tmp_path / "voc"), n=2, size=(240, 320))
    res = predict.main(["--model", "ssd", "--device", "cpu", "--ckpt",
                        str(ckpt), "--src", imgs[0], "--dst",
                        str(tmp_path / "det")])
    assert len(res) == 1 and os.path.isfile(res[0]["saved"])
    q = predict.main(["--model", "ssd", "--device", "cpu", "--int8",
                      "--src", *imgs[:2], "--dst", str(tmp_path / "q")])
    assert len(q) == 2 and all(os.path.isfile(r["saved"]) for r in q)
    monkeypatch.setenv("TPUCV_VOC_ROOT", str(tmp_path / "voc"))
    out = evaluate.main(["--model", "ssd", "--device", "cpu", "--ckpt",
                         str(ckpt), "--batch-size", "2"])
    assert "mAP" in out and "coco" in out
    q = evaluate.main(["--model", "ssd", "--device", "cpu", "--int8",
                       "--batch-size", "2"])
    assert "mAP" in q
    server = serve.build(["--model", "ssd", "--device", "cpu", "--host",
                          "127.0.0.1", "--port", "0", "--batch", "1",
                          "--int8", "--calib",
                          str(tmp_path / "voc" / "JPEGImages")])
    try:
        assert quant.count_quantized(server.batcher.model) == N_QUANT
    finally:
        server.batcher.stop()
        server.server_close()
    assert "ssd" in capsys.readouterr().out


def test_cli_refuses_a_missing_card(cli):
    """By default the CLIs run on the card; with none they raise rather
    than move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, predict, _, _ = cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--model", "ssd", "--src", "x.jpg"])
