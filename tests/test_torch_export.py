"""tpucv_torch's export layer (``tpucv_torch/deploy.py``) against tpucv's
(``tpucv/deploy.py``), on the CPU.

- The Tiny conv round trip of ``tests/test_tools.py:92-112``: flax's Tiny
  conv and the port's ``nn.Conv2d`` on its kernel; the artifact of
  ``export_serialized`` reloads with ``load_serialized`` and gives the
  eager output bit for bit, within 1e-5 of tpucv's.
- The quantized ``ConvBnAct`` round trip of ``tests/test_quant.py:239-255``:
  tpucv's quant entries carried into the port; the reloaded artifact's
  output bit-equal to the eager int8 route (which differs from the float
  one), and within 1 f32 ulp of tpucv's int8 output.
- The int8 YOLOv8n's served forward under bf16 autocast: the reloaded
  artifact's raw maps bit-equal to the eager int8 forward's.
- YOLOv8n's serving program (uint8 -> ``letterbox_static`` -> normalize ->
  forward -> ``decode_boxes`` with ``pre_nms_topk`` 512, ``max_det`` 50 of
  the 84 anchors) at 64² on narrow 48x64 inputs, from the port's seed-0
  weights (class branch sharpened as the serving tests do) carried into
  flax by tpucv's ``import_yolov8``: ``export_stablehlo``'s text calls
  the ``tpucv.nms_keep`` operator; the reloaded artifact gives the eager
  detections bit for bit; it and ``aot_compile`` give tpucv's
  ``decode_boxes`` valid set and classes, boxes within 1e-3 px and scores
  within 1e-5 (the f32 forwards part by ~1e-5, ``test_torch_yolov8.py``),
  and so does the compiled program against the eager one (inductor fuses
  the f32 arithmetic in another order, so it is not bit-equal);
  ``aot_compile`` raises on another batch size or dtype, as a JAX
  ``Compiled`` does.

``aot_compile`` runs inductor on the CPU here, about a minute for the
program: one module-scoped compile serves both of its tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_quant import _realistic_convbn_vars
from test_torch_quant import nchw, nhwc, port_convbn
from tpucv import quant as jq
from tpucv.ckpt.importer import import_yolov8
from tpucv.decode.yolov8 import decode_boxes as j_decode_boxes
from tpucv.deploy import export_serialized as j_export_serialized
from tpucv.deploy import load_serialized as j_load_serialized
from tpucv.models.yolov8 import Yolo8 as FlaxYolo8
from tpucv.nn.blocks import ConvBnAct as JConvBnAct
from tpucv.ops.preprocess import letterbox_static as j_letterbox_static
from tpucv.ops.preprocess import normalize_images as j_normalize_images
from tpucv_torch import deploy, quant
from tpucv_torch.bench import yolo8n
from tpucv_torch.decode.yolov8 import decode_boxes
from tpucv_torch.ops import cuda_nms
from tpucv_torch.ops.preprocess import letterbox_static, normalize_images

torch.set_num_threads(1)
CLS_GAIN = 3000.0
SIZE = 64
# the bench's decode (K = min(512, 84 anchors at 64²)), max_det within K
DECODE = dict(conf_threshold=0.25, iou_threshold=0.7, max_det=50,
              pre_nms_topk=512)


def test_tiny_conv_round_trip():
    from flax import linen as fnn

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(4, (3, 3), padding="SAME")(x)

    model = Tiny()
    x = np.random.default_rng(0).normal(size=(1, 8, 8, 3)).astype(np.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(j_load_serialized(j_export_serialized(
        lambda xx: model.apply(v, xx), jnp.asarray(x)))(jnp.asarray(x)))

    conv = torch.nn.Conv2d(3, 4, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(
            np.asarray(v["params"]["Conv_0"]["kernel"]), (3, 2, 0, 1))))
        conv.bias.copy_(torch.from_numpy(
            np.asarray(v["params"]["Conv_0"]["bias"])))

    def fn(xx):
        return conv(xx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    xt = torch.from_numpy(x)
    data = deploy.export_serialized(fn, xt)
    assert isinstance(data, bytes) and len(data) > 500
    out = deploy.load_serialized(data)(xt)
    with torch.no_grad():
        assert torch.equal(out, fn(xt))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_quantized_convbnact_round_trip_bit_equal():
    rng = np.random.default_rng(5)
    jm = JConvBnAct(8, 3, 1, dtype=jnp.float32)
    x = rng.normal(0, 1, (1, 8, 8, 8)).astype(np.float32)
    v = _realistic_convbn_vars(rng, jm, jnp.asarray(x), 8, 8)
    qv = jq.quantize_for_inference(jm, v, [jnp.asarray(x)])
    ref = np.asarray(jm.apply(qv, jnp.asarray(x)))

    q = port_convbn(qv, 8, 8, 3)
    assert quant.count_quantized(q) == 1
    xt = nchw(x)
    data = deploy.export_serialized(q, xt)
    out = deploy.load_serialized(data)(xt)
    with torch.no_grad():
        eager = q(xt)
        assert torch.equal(out, eager)
        assert not torch.equal(eager, port_convbn(v, 8, 8, 3)(xt))
    np.testing.assert_allclose(nhwc(out), ref, rtol=1.2e-7, atol=1e-6)


def test_quantized_yolo8n_served_forward_round_trip_bit_equal():
    """The int8 YOLOv8n's served forward (bench's, under bf16 autocast) at
    64²: the reloaded artifact's raw maps are the eager int8 forward's bit
    for bit, in bf16. The exported program carries autocast's casts as
    traced, so the loaded graph casts as the eager one did."""
    from tpucv_torch.bench import inference_program, prep

    model = yolo8n(torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 255, (2, 48, SIZE, 3), dtype=np.uint8))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        q = quant.quantize_for_inference(model, [prep(x, SIZE, True)])
    assert quant.count_quantized(q) == 56
    fwd, _ = inference_program(q, SIZE, amp=True)
    with torch.no_grad():
        eager = fwd(x)
    out = deploy.load_serialized(deploy.export_serialized(fwd, x))(x)
    for a, b in zip(out, eager):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def _sharpened_yolo8n():
    model = yolo8n(torch.device("cpu"))
    with torch.no_grad():
        for lv in range(3):
            head = model.model[22].cv3[lv][2]
            head.weight.mul_(CLS_GAIN)
            head.bias.zero_()
    return model


@pytest.fixture(scope="module")
def served():
    """(eager program, input, eager detections, tpucv's detections)."""
    model = _sharpened_yolo8n()

    def program(raw_u8):
        lb, _, _ = letterbox_static(raw_u8, SIZE)
        return decode_boxes(model(normalize_images(lb, torch.float32)),
                            **DECODE)

    x = np.random.default_rng(0).integers(0, 255, (2, 48, SIZE, 3),
                                          dtype=np.uint8)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        eager = program(xt)

    fmodel = FlaxYolo8(scale="n", nc=80)
    variables = import_yolov8({k: v.detach().float().numpy().copy()
                               for k, v in model.state_dict().items()})

    @jax.jit
    def j_program(raw_u8):
        lb, _, _ = j_letterbox_static(raw_u8, SIZE)
        raw = fmodel.apply(variables, j_normalize_images(lb, jnp.float32))
        return j_decode_boxes(raw, **DECODE)

    ref = [np.asarray(a) for a in j_program(jnp.asarray(x))]
    return program, xt, eager, ref


def _assert_detections(out, ref):
    """Same valid set and classes; boxes within 1e-3 px, scores 1e-5."""
    rb, rs, rc, rv = (np.asarray(a) for a in ref)
    boxes, scores, classes, valid = (t.numpy() for t in out)
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, rv)
    np.testing.assert_array_equal(classes[valid], rc[rv])
    np.testing.assert_allclose(boxes[valid], rb[rv], atol=1e-3, rtol=0)
    np.testing.assert_allclose(scores[valid], rs[rv], atol=1e-5, rtol=0)


def test_stablehlo_text_names_the_nms_operator(served):
    program, xt, _, _ = served
    text = deploy.export_stablehlo(program, xt)
    assert "tpucv.nms_keep" in text
    assert "ExportedProgram" in text


def test_serialized_program_matches_eager_and_tpucv(served):
    program, xt, eager, ref = served
    loaded = deploy.load_serialized(deploy.export_serialized(program, xt))
    with torch.no_grad():
        out = loaded(xt)
    for a, b in zip(out, eager):
        assert torch.equal(a, b)
    _assert_detections(out, ref)


@pytest.fixture(scope="module")
def compiled(served):
    program, xt, _, _ = served
    return deploy.aot_compile(program, xt)


def test_aot_compile_matches_eager_and_tpucv(served, compiled):
    _, xt, eager, ref = served
    out = compiled(xt)
    _assert_detections(out, [t.numpy() for t in eager])
    _assert_detections(out, ref)


def test_aot_compile_is_shape_locked(served, compiled):
    _, xt, _, _ = served
    with pytest.raises(TypeError, match="compiled for"):
        compiled(xt[:1])
    with pytest.raises(TypeError, match="compiled for"):
        compiled(xt.float())


def test_nms_keep_is_a_registered_operator():
    """``nms_keep`` goes through ``torch.ops.tpucv.nms_keep``: the CPU
    kernel is the plain version, and the fake kernel gives a (B, K) bool
    mask, which is what ``torch.export`` traces."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 50, (3, 40, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 30, (3, 40, 2)).astype(np.float32)], -1))
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (3, 40)), -1)
                              .astype(np.float32))
    keep = cuda_nms.nms_keep(boxes, scores, 0.5)
    assert torch.equal(keep, cuda_nms.nms_keep_reference(boxes, scores, 0.5))
    assert torch.equal(torch.ops.tpucv.nms_keep(boxes, scores, 0.5), keep)
    with FakeTensorMode() as mode:
        fake = torch.ops.tpucv.nms_keep(mode.from_tensor(boxes),
                                        mode.from_tensor(scores), 0.5)
    assert fake.shape == (3, 40) and fake.dtype == torch.bool
    assert cuda_nms.nms_keep.launches == 0      # no card: nothing launched
