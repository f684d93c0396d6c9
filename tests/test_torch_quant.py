"""tpucv_torch int8 post-training quantization against tpucv's
(``tpucv/quant.py``), on the CPU.

The port mirrors the non-slow YOLOv8 cases of ``tests/test_quant.py``
(lines 33-238) and holds itself against tpucv on the same inputs:

- the builder's entries (``qkernel`` packed, ``xscale``, ``scale``,
  ``bias``) bit-equal to ``build_quant_collection``'s, BN eps 1e-3 and
  1e-5;
- one conv (1x1, 3x3, 3x3 stride 2) fed the same input and tpucv's quant
  entries (through ``ckpt.convert.quant_buffer``): the quantized
  activation and the int32 accumulators bit-equal to tpucv's quantize step
  and ``lax.conv_general_dilated(..., preferred_element_type=int32)``,
  the output within 1 ulp (f32) of tpucv's;
- full YOLOv8n (nc 16, 64²) on tpucv's own case (its init, input from
  seed 4, test_quant.py:113-136) with tpucv's quant collection carried
  across: each level's int8 maps within ``INT8_MAP_SHARE`` (a quarter) of
  tpucv's own int8-against-f32 error of tpucv's int8 maps (measured: 0,
  bit-equal); with BatchNorm drawn from a seed, the port's own
  calibration at tpucv's bars (relative < 0.1, cosine > 0.999). With
  such BatchNorm the two engines' float SiLU (XLA's logistic, PyTorch's)
  part by an ulp in about a fifth of the elements, and now and then that
  puts one activation on the other side of a rounding boundary: a
  one-step flip, as large as a quantization error, that reaches every
  element of a 2x2 P5 map after it (seeds 3 and 4 of 0-5 flip, the rest
  agree within 1e-3 of tpucv's own error). The quarter bound is therefore
  held on tpucv's case, where no float op parts the engines;
- seg and pose at 64²: tpucv's count of quantized convs, and the GEMM
  route's layout (im2col, padding, un-padding) with an exact int64 GEMM
  bit-equal to the plain route on every quantized conv, the pose head's
  51-wide ones (N, K padded) and the P5 convs at B=1 (M = 4 <= 16)
  among them.

The card's GEMM (``torch._int_mm``) runs only on the card: chip_smoke.py's
``int8_parity`` phase holds it against the plain route there.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_quant import _realistic_convbn_vars
from test_torch_yolov8 import randomize_bn
from tpucv import quant as jq
from tpucv.models.yolov8 import Yolo8 as FlaxYolo8
from tpucv.nn.blocks import ConvBnAct as JConvBnAct
from tpucv.nn.blocks import DWConv as JDWConv
from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.ckpt.convert import from_flax_variables, quant_buffer
from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.nn.blocks import ConvBnAct
from tpucv_torch.ops import int8_conv

torch.set_num_threads(1)
INT8_MAP_SHARE = 0.25       # port int8 vs tpucv int8, of tpucv int8 vs f32
REL_INT8, COS_INT8 = 0.1, 0.999     # tpucv's bars, test_quant.py:113-136
BF16_REL = 0.05             # test_quant.py:195-210
TOP_SCORE_TOL = 0.05        # test_quant.py:139-165
SIZE = 64


def port_convbn(v, in_ch, out_ch, k, s=1, g=1, act=True):
    """A port ``ConvBnAct`` loaded (strict) from a tpucv one's variables,
    its quant entries included when they are there."""
    m = ConvBnAct(in_ch, out_ch, k, s, g=g, act=act)
    p, b = v["params"], v["batch_stats"]
    sd = {"conv.weight": np.transpose(np.asarray(p["conv"]["kernel"]),
                                      (3, 2, 0, 1)),
          "bn.weight": p["bn"]["scale"], "bn.bias": p["bn"]["bias"],
          "bn.running_mean": b["bn"]["mean"],
          "bn.running_var": b["bn"]["var"]}
    sd = {k_: torch.from_numpy(np.array(a, np.float32)) for k_, a in
          sd.items()}
    sd["bn.num_batches_tracked"] = torch.tensor(0)
    sd.update(quant_buffer(k_, a) for k_, a in v.get("quant", {}).items())
    m.load_state_dict(sd, strict=True)
    return m.eval()


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ one conv
def test_quant_path_is_exact_when_lossless():
    """Integer inputs and weights with scales of 1 quantize without
    rounding: the port's int8 output is bit-equal to its float output and
    to tpucv's int8 output."""
    rng = np.random.default_rng(0)
    jm = JConvBnAct(8, 3, 1, dtype=jnp.float32)
    x = rng.integers(-127, 128, (1, 8, 8, 8)).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    kern = rng.integers(-127, 128, (3, 3, 8, 8)).astype(np.float32)
    kern.reshape(-1, 8)[0] = 127          # per-channel max -> wscale = 1
    v["params"]["conv"]["kernel"] = kern
    v["params"]["bn"]["scale"] = np.full(8, 1.0, np.float32)
    v["params"]["bn"]["bias"] = np.zeros(8, np.float32)
    v["batch_stats"]["bn"]["mean"] = np.zeros(8, np.float32)
    v["batch_stats"]["bn"]["var"] = np.full(8, 1.0 - 1e-3, np.float32)
    calib = x.copy()
    calib[0, 0, 0, 0] = 127.0             # absmax 127 -> xscale = 1
    qv = jq.quantize_for_inference(jm, v, [jnp.asarray(calib)])
    ref_int8 = np.asarray(jm.apply(qv, jnp.asarray(x)), np.float32)

    m = port_convbn(v, 8, 8, 3)
    q = quant.quantize_for_inference(m, [nchw(calib)])
    assert quant.count_quantized(q) == jq.count_quantized(qv["quant"]) == 1
    with torch.no_grad():
        flt, out = m(nchw(x)), q(nchw(x))
    assert torch.equal(out, flt)
    np.testing.assert_array_equal(nhwc(out), ref_int8)


@pytest.mark.parametrize("k,eps", [(3, 1e-3), (1, 1e-3), (3, 1e-5)])
def test_builder_entries_bit_equal(k, eps):
    """Same weights, same absmax: ``quantize_convbn`` gives tpucv's entries
    bit for bit; the calibration records tpucv's absmax and its f32 eps."""
    rng = np.random.default_rng(10 + k)
    jm = JConvBnAct(24, k, 1, dtype=jnp.float32)
    x = rng.normal(0, 2, (2, 8, 8, 16)).astype(np.float32)
    v = _realistic_convbn_vars(rng, jm, jnp.asarray(x), 24, 16, k=k)
    m = port_convbn(v, 16, 24, k)
    m.bn.eps = eps

    stats = quant.calibrate(m, [nchw(x)])
    absmax, got_eps = stats[""]
    assert absmax == float(np.float32(np.abs(x).max()))
    assert got_eps == float(np.float32(eps))
    jstats = {"conv::bn::in_absmax": np.float32(absmax),
              "conv::bn::eps": np.float32(eps)}
    ref = jq.build_quant_collection(v, jstats)
    bn = m.bn
    qk, xscale, scale, bias = quant.quantize_convbn(
        m.conv.weight.detach().numpy(), bn.weight.detach().numpy(),
        bn.bias.detach().numpy(), bn.running_mean.numpy(),
        bn.running_var.numpy(), got_eps, absmax)
    q = quant.quantize_for_inference(m, [nchw(x)])
    for name, got in (("qkernel", qk), ("xscale", xscale),
                      ("scale", scale), ("bias", bias)):
        want = np.asarray(ref[f"conv::{name}"])
        if name == "qkernel":
            want = np.transpose(want, (3, 2, 0, 1))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        buf, t = quant_buffer(f"conv::{name}", ref[f"conv::{name}"])
        assert torch.equal(getattr(q, buf), t), name


ROUND_HALF = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5])


@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2)])
def test_conv_parity_with_tpucv(k, s):
    """tpucv's quant entries carried across: xq and the int32 accumulators
    bit-equal to tpucv's, through both of the port's routes; y within 1
    ulp. The calibration absmax 127/8 makes xscale 1/8, so inputs of
    (j + 0.5)/8 land on .5 exactly: round half to even."""
    rng = np.random.default_rng(20 + 3 * k + s)
    ci, co = 16, 24
    jm = JConvBnAct(co, k, s, act=False, dtype=jnp.float32)
    x = rng.normal(0, 2, (2, 9, 9, ci)).astype(np.float32)
    x.reshape(-1)[:ROUND_HALF.size * 20] = np.tile(ROUND_HALF, 20) / 8.0
    x = np.clip(x, -15.875, 15.875)
    v = _realistic_convbn_vars(rng, jm, jnp.asarray(x), co, ci, k=k)
    calib = x.copy()
    calib[0, 0, 0, 0] = 127.0 / 8.0
    qv = jq.quantize_for_inference(jm, v, [jnp.asarray(calib)])
    e = qv["quant"]
    assert float(e["conv::xscale"]) == 0.125

    # tpucv's quantize step and int32 conv (tpucv/quant.py:91-98)
    jx = jnp.asarray(x)
    jxq = jnp.clip(jnp.round(jx.astype(jnp.float32)
                             * (1.0 / e["conv::xscale"])),
                   -127.0, 127.0).astype(jnp.int8)
    p = k // 2
    jacc = jax.lax.conv_general_dilated(
        jxq, e["conv::qkernel"], (s, s), ((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    ref_y = np.asarray(jm.apply(qv, jx))

    m = port_convbn(qv, ci, co, k, s, act=False)
    xq = quant.quantize_activation(nchw(x), m.xscale)
    np.testing.assert_array_equal(nhwc(xq), np.asarray(jxq))
    halves = xq.permute(0, 2, 3, 1).reshape(-1)[:ROUND_HALF.size].numpy()
    np.testing.assert_array_equal(halves, np.round(ROUND_HALF))
    geom = (m.conv.kernel_size, m.conv.stride, m.conv.padding,
            m.conv.dilation, m.conv.groups)
    for acc in (int8_conv.int8_conv(xq, m.qweight, *geom),
                int8_conv.conv_gemm(xq, m.qweight, *geom,
                                    gemm=int8_conv.int64_mm)):
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(nhwc(acc), np.asarray(jacc))
    with torch.no_grad():
        y = m(nchw(x))
    np.testing.assert_array_max_ulp(nhwc(y), ref_y, maxulp=1)


def test_skips_narrow_and_depthwise():
    """The 3-channel stem and a depthwise conv stay float, in both."""
    rng = np.random.default_rng(2)
    x = rng.random((1, 16, 16, 3), np.float32)
    jm = JConvBnAct(16, 3, 2, dtype=jnp.float32)
    qv = jq.quantize_for_inference(
        jm, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), [jnp.asarray(x)])
    stem = ConvBnAct(3, 16, 3, 2).eval()
    assert quant.count_quantized(
        quant.quantize_for_inference(stem, [nchw(x)])) == 0 == \
        jq.count_quantized(qv["quant"])

    xd = rng.random((1, 16, 16, 16), np.float32)
    jd = JDWConv(16, 3, 1, dtype=jnp.float32)
    qvd = jq.quantize_for_inference(
        jd, jd.init(jax.random.PRNGKey(0), jnp.asarray(xd)),
        [jnp.asarray(xd)])
    dw = ConvBnAct(16, 16, 3, g=16).eval()
    assert quant.count_quantized(
        quant.quantize_for_inference(dw, [nchw(xd)])) == 0 == \
        jq.count_quantized(qvd["quant"])


def test_bn_fold_matches_float_pipeline():
    """The dequantized folded kernel and bias against the port's float
    conv -> BN in float64: the only gap is the kernel's int8 rounding,
    at most wscale/2 a tap (test_quant.py:89-111)."""
    rng = np.random.default_rng(3)
    jm = JConvBnAct(8, 1, 1, act=False, dtype=jnp.float32)
    x = rng.normal(0, 1, (1, 4, 4, 8)).astype(np.float32)
    v = _realistic_convbn_vars(rng, jm, jnp.asarray(x), 8, 8, k=1)
    m = port_convbn(v, 8, 8, 1, act=False)
    q = quant.quantize_for_inference(m, [nchw(x)])
    scale = q.qscale.double().numpy()
    xscale = float(q.xscale)
    w = int8_conv.oihw(q.qweight, (1, 1)).double().numpy() \
        * scale[:, None, None, None] / xscale
    man = np.einsum("bhwc,oc->bhwo", x.astype(np.float64), w[:, :, 0, 0]) \
        + q.qbias.double().numpy()
    with torch.no_grad():
        ref = nhwc(m(nchw(x))).astype(np.float64)
    bound = (np.abs(x).max() * 8 * (scale / xscale) / 2).max()
    assert np.abs(ref - man).max() <= bound + 1e-4


def test_bf16_autocast_output():
    """Under bf16 autocast the int8 path quantizes the bf16 activation
    through f32 and returns bf16, close to the bf16 float path; tpucv's
    own bf16 module meets the same bar on the same weights."""
    rng = np.random.default_rng(7)
    jm = JConvBnAct(32, 3, 1, dtype=jnp.bfloat16)
    x = rng.normal(0, 2, (2, 16, 16, 16)).astype(np.float32)
    v = _realistic_convbn_vars(rng, jm, jnp.asarray(x), 32, 16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    qv = jq.quantize_for_inference(jm, v, [xb])
    jref = np.asarray(jm.apply(v, xb), np.float32)
    jout = np.asarray(jm.apply(qv, xb), np.float32)
    assert np.abs(jref - jout).max() / np.abs(jref).max() < BF16_REL

    m = port_convbn(v, 16, 32, 3)
    xt = nchw(x).to(torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        q = quant.quantize_for_inference(m, [xt])
        with torch.no_grad():
            ref, out = m(xt), q(xt)
    assert quant.count_quantized(q) == 1
    assert out.dtype == ref.dtype == torch.bfloat16
    rel = (ref.float() - out.float()).abs().max() / ref.float().abs().max()
    assert float(rel) < BF16_REL, float(rel)


def test_checkpoint_round_trip(tmp_path):
    """``save_pure`` of a quantized model keeps its int8 buffers; its file
    loads into a float-built model (strict), which then runs the int8 path
    bit for bit (test_quant.py:213-236)."""
    rng = np.random.default_rng(6)
    jm = JConvBnAct(8, 3, 1, dtype=jnp.float32)
    x = rng.normal(0, 1, (1, 8, 8, 8)).astype(np.float32)
    v = _realistic_convbn_vars(rng, jm, jnp.asarray(x), 8, 8)
    m = port_convbn(v, 8, 8, 3)
    q = quant.quantize_for_inference(m, [nchw(x)])
    path = CheckPoint.save_pure(q, str(tmp_path / "q.ckpt"))
    template = port_convbn(v, 8, 8, 3)
    assert not set(quant.QUANT_BUFFERS) & set(template.state_dict())
    template.load_state_dict(CheckPoint.load_pure(path), strict=True)
    assert template.qweight.dtype == torch.int8
    assert quant.count_quantized(template) == 1
    with torch.no_grad():
        assert torch.equal(template(nchw(x)), q(nchw(x)))
        assert not torch.equal(m(nchw(x)), q(nchw(x)))


def test_train_mode_runs_the_float_path():
    rng = np.random.default_rng(8)
    x = nchw(rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32))
    m = ConvBnAct(16, 16, 3).eval()
    q = quant.quantize_for_inference(m, [x])
    q.train()
    m.train()
    assert torch.equal(q(x), m(x))


# ------------------------------------------------------------ full models
@pytest.fixture(scope="module")
def flax_yolo8n():
    fm = FlaxYolo8(scale="n", nc=16, reg_max=16, dtype=jnp.float32)
    v = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    return fm, jax.device_get(v)


@pytest.fixture(scope="module")
def yolo8n(flax_yolo8n):
    """tpucv's YOLOv8n (nc 16) with BatchNorm drawn from a seed, tpucv's
    quantized variables calibrated on a seeded batch, and the input."""
    fm, v = flax_yolo8n
    rng = np.random.default_rng(4)
    v = {"params": randomize_bn(v["params"], rng),
         "batch_stats": randomize_bn(v["batch_stats"], rng)}
    x = rng.random((2, SIZE, SIZE, 3), np.float32)
    qv = jq.quantize_for_inference(fm, v, [jnp.asarray(x)])
    return fm, v, qv, x


def _flat(maps):
    return np.concatenate([np.asarray(t, np.float32).ravel() for t in maps])


def test_full_yolo8n_int8_maps_match_tpucv(flax_yolo8n):
    """tpucv's case (test_quant.py:113-136): its init, x from seed 4."""
    fm, v = flax_yolo8n
    x = np.random.default_rng(4).random((2, SIZE, SIZE, 3), np.float32)
    qv = jq.quantize_for_inference(fm, v, [jnp.asarray(x)])
    ref_f32 = fm.apply(v, jnp.asarray(x))
    ref_int8 = fm.apply(qv, jnp.asarray(x))
    model = Yolo8("n", nc=16)
    model.load_state_dict(from_flax_variables(qv), strict=True)
    model.eval()
    assert quant.count_quantized(model) == jq.count_quantized(qv["quant"])
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for o, r8, r32 in zip(out, ref_int8, ref_f32):
        r8, r32 = np.asarray(r8), np.asarray(r32)
        own = np.abs(r8 - r32).max()
        gap = np.abs(o.numpy() - r8).max()
        assert gap <= INT8_MAP_SHARE * own, (gap, own)


def test_full_yolo8n_port_calibration_close_to_float(yolo8n):
    fm, v, qv, x = yolo8n
    model = Yolo8("n", nc=16)
    model.load_state_dict(from_flax_variables(v), strict=True)
    model.eval()
    xt = torch.from_numpy(x)
    q = quant.quantize_for_inference(model, [xt])
    n = quant.count_quantized(q)
    assert n == jq.count_quantized(qv["quant"]) and n > 40, n
    assert quant.count_quantized(model) == 0     # the float model untouched
    with torch.no_grad():
        ref, out = model(xt), q(xt)
    for r, o in zip(ref, out):
        rel = (r - o).abs().max() / (r.abs().max() + 1e-9)
        assert float(rel) < REL_INT8, float(rel)
    rf, of = _flat(ref), _flat(out)
    cos = float((rf * of).sum() / (np.linalg.norm(rf) * np.linalg.norm(of)))
    assert cos > COS_INT8, cos


@pytest.mark.parametrize("head,nc", [("segment", 80), ("pose", 1)])
def test_seg_pose_counts_and_gemm_layout(head, nc):
    """tpucv's count of quantized convs; every quantized conv's GEMM-route
    layout (with the exact int64 GEMM) bit-equal to the plain route at
    B=1, 64²: pose's 51-wide convs pad N (and K for 51 -> 51), the P5
    convs have M = 4."""
    fm = FlaxYolo8(scale="n", nc=nc, head=head, dtype=jnp.float32)
    v = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    x = np.random.default_rng(5).random((1, SIZE, SIZE, 3), np.float32)
    qv = jq.quantize_for_inference(fm, v, [jnp.asarray(x)])
    model = Yolo8("n", nc=nc, head=head)
    model.load_state_dict(from_flax_variables(v), strict=True)
    model.eval()
    xt = torch.from_numpy(x)
    q = quant.quantize_for_inference(model, [xt])
    assert quant.count_quantized(q) == jq.count_quantized(qv["quant"])

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
    assert len(seen) == quant.count_quantized(q)
    padded, short = [], []
    for name, m, xi in seen:
        c = m.conv
        geom = (c.kernel_size, c.stride, c.padding, c.dilation, c.groups)
        xq = quant.quantize_activation(xi, m.xscale)
        acc = int8_conv.conv_gemm(xq, m.qweight, *geom,
                                  gemm=int8_conv.int64_mm)
        assert torch.equal(acc, int8_conv.conv_plain(xq, m.qweight, *geom)), \
            name
        M = acc.shape[0] * acc.shape[2] * acc.shape[3]
        K, N = m.qweight.shape[1], m.qweight.shape[0]
        if int8_conv.gemm_dims(M, K, N) != (M, K, N):
            padded.append((name, M, K, N))
        if M <= 16:
            short.append(name)
    assert short, "no conv with M <= 16"
    if head == "pose":
        wide = [n for n, _, _, N in padded if N == 51]
        assert len(wide) == 6 and all(".cv4." in n for n in wide), padded
        assert sum(1 for _, _, K, _ in padded if K == 9 * 51) == 3


@pytest.mark.parametrize("B,cin,H,cout,k,s,g", [
    (1, 16, 2, 24, 3, 1, 1),        # M = 4: rows padded to 32
    (2, 16, 9, 24, 3, 2, 2),        # grouped: one GEMM a group
    (2, 51, 5, 51, 3, 1, 1)])       # K = 459, N = 51: both padded
def test_gemm_layout_equals_plain_route(B, cin, H, cout, k, s, g):
    """``conv_gemm``'s im2col, padding and un-padding with the exact int64
    GEMM against ``conv_plain``, on int8 values at their extremes."""
    rng = np.random.default_rng(cin + k + g)
    xq = torch.from_numpy(rng.integers(-127, 128, (B, cin, H, H),
                                       dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, k * k * cin // g),
                                       dtype=np.int8))
    geom = ((k, k), (s, s), (k // 2, k // 2), (1, 1), g)
    got = int8_conv.conv_gemm(xq, wq, *geom, gemm=int8_conv.int64_mm)
    assert torch.equal(got, int8_conv.conv_plain(xq, wq, *geom))


# ------------------------------------------------------------ the harness
def _algo(nc=8):
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    cfg.dataset.input_size = SIZE
    cfg.train.mixed_precision = False
    cfg.decode.pre_nms_topk = 64
    cfg.decode.max_det = 16
    algo = algo_cls(cfg, device="cpu")
    algo.nc = nc
    return algo


def test_quantize_variables_harness():
    """``quantize_variables`` on the synthetic index through the production
    letterbox: tpucv's count, and a top score within 0.05 of the float
    path's and of tpucv's int8 top score on the same weights."""
    from tpucv.algorithms.yolov8 import YOLOv8 as JYOLOv8
    from tpucv.configs.model_cfgs import Yolo8DetConfig
    from tpucv.data.detection_dataset import \
        SyntheticDetectionIndex as JSynthetic

    jcfg = Yolo8DetConfig()
    jcfg.dataset.input_size = SIZE
    jcfg.train.mixed_precision = False
    jcfg.decode.pre_nms_topk = 64
    jcfg.decode.max_det = 16
    jalgo = JYOLOv8(jcfg)
    jalgo.nc = 8
    variables = jalgo.init_variables(seed=0)
    qv = jalgo.quantize_variables(
        variables, JSynthetic(4, SIZE, 8, max_objects=2, seed=0),
        n_images=4, batch_size=2)

    algo = _algo()
    model = algo.build_model()
    model.load_state_dict(from_flax_variables(variables), strict=True)
    model.eval()
    index = SyntheticDetectionIndex(4, SIZE, 8, max_objects=2, seed=0)
    q = algo.quantize_variables(model, index, n_images=4, batch_size=2)
    assert quant.count_quantized(q) == jq.count_quantized(qv["quant"]) > 40

    img = np.zeros((1, SIZE, SIZE, 3), np.uint8)
    img[0, 16:48, 16:48] = 200
    infer = algo.make_infer_fn(conf_threshold=0.0)
    sf = infer(model, torch.from_numpy(img))[1]
    sq = infer(q, torch.from_numpy(img))[1]
    jsq = np.asarray(jalgo.make_infer_fn(conf_threshold=0.0)(
        qv, jnp.asarray(img))[1])
    assert abs(float(sf[0, 0]) - float(sq[0, 0])) < TOP_SCORE_TOL
    assert abs(float(sq[0, 0]) - float(jsq[0, 0])) < TOP_SCORE_TOL


def test_quantize_variables_refuses_models_without_hooks():
    class PlainConvNet(torch.nn.Module):         # no ConvBnAct anywhere
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)

        def forward(self, x):
            return self.conv(x.permute(0, 3, 1, 2))

    index = SyntheticDetectionIndex(2, SIZE, 8, max_objects=1, seed=0)
    with pytest.raises(ValueError, match="no quantizable convs"):
        _algo().quantize_variables(PlainConvNet().eval(), index,
                                   n_images=1, batch_size=1)
    with pytest.raises(ValueError, match="at least one image"):
        _algo().quantize_variables(PlainConvNet().eval(), index,
                                   n_images=0)


# ------------------------------------------------------------ the CLIs
ROOT = Path(__file__).resolve().parent.parent
CLI_SIZE = 160


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The CLIs' registry at input 160, f32, run in ``tmp_path``."""
    from tpucv_torch import evaluate, predict, serve

    def shrunk(name):
        cfg, algo, cls = export_from_registry(name)
        cfg.dataset.input_size = CLI_SIZE
        cfg.train.mixed_precision = False
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    for mod in (predict, evaluate, serve):
        monkeypatch.setattr(mod, "export_from_registry", shrunk)
    return predict, evaluate, serve


def _images(tmp_path, n=3):
    import cv2
    rng = np.random.default_rng(9)
    paths = []
    for i in range(n):
        img = rng.integers(0, 256, (120 + 20 * i, 160, 3), np.uint8)
        p = str(tmp_path / "imgs" / f"{i}.{'png' if i == 2 else 'jpg'}")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        cv2.imwrite(p, img[..., ::-1])
        paths.append(p)
    return paths


def test_predict_cli_int8_images_and_video(small, tmp_path):
    import cv2
    predict = small[0]
    srcs = _images(tmp_path)
    results = predict.main(["--model", "yolo8_det", "--device", "cpu",
                            "--int8", "--src", *srcs, "--dst", "out"])
    assert len(results) == 3 and all(r["saved"] for r in results)
    assert len(os.listdir(tmp_path / "out")) == 3

    video = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                             (160, 120))
    for k in range(10):
        writer.write(np.full((120, 160, 3), 20 * k, np.uint8))
    writer.release()
    out = predict.main(["--model", "yolo8_det", "--device", "cpu", "--int8",
                        "--type", "video", "--src", video, "--dst", "vid"])
    assert os.path.isfile(out[0])
    with pytest.raises(SystemExit, match="needs at least one --src"):
        predict.main(["--model", "yolo8_det", "--device", "cpu", "--int8"])


def test_evaluate_cli_int8(small, tmp_path, monkeypatch):
    import subprocess
    import sys
    evaluate = small[1]
    root = tmp_path / "coco"
    subprocess.run([sys.executable, "scripts/make_synthetic_coco.py",
                    "--root", str(root), "--n", "4"], check=True, cwd=ROOT)
    monkeypatch.setenv("TPUCV_COCO_ROOT", str(root))
    stats = evaluate.main(["--model", "yolo8_det", "--dataset", "coco",
                           "--device", "cpu", "--batch-size", "2", "--int8"])
    assert len(stats) == 12
    assert all(-1.0 <= s <= 1.0 for s in stats.values())


def test_serve_build_int8(small, tmp_path):
    serve = small[2]
    _images(tmp_path)
    server = serve.build(["--model", "yolo8_det", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", "0",
                          "--batch", "2", "--int8",
                          "--calib", str(tmp_path / "imgs")])
    try:
        assert quant.count_quantized(server.batcher.model) == 56
        out = server.batcher.submit(np.zeros((120, 160, 3), np.uint8))
        assert isinstance(out["detections"], list), out
    finally:
        server.batcher.stop()
        server.server_close()
    with pytest.raises(SystemExit, match="needs --calib"):
        serve.build(["--model", "yolo8_det", "--device", "cpu", "--int8"])
    with pytest.raises(SystemExit, match="matched no images"):
        serve.build(["--model", "yolo8_det", "--device", "cpu", "--int8",
                     "--calib", str(tmp_path / "none" / "*.jpg")])
