"""tpucv_torch's spatial partitioning (``tpucv_torch/parallel/spatial.py``)
and batch-sharded inference (``parallel/mesh.py:sharded_infer``) against
tpucv and against one process, on the CPU: four gloo ranks started once
(``torch_dp_workers.case_spatial_world``), one thread each, on a (2, 2)
and a (1, 4) mesh (batch over the data axis, height over the model axis).

- tpucv's ``test_spatial_partitioning_matches_replicated``
  (``tests/test_parallel.py:296-329``): its net (3x3 stride-2 SAME convs,
  whose flax padding is (0, 1), a 2x2 average pool, a 3x3 SAME conv) on
  (4, 32, 32, 3), the sum of its squared outputs: the loss within 1e-5
  relative and the gradients within rtol / atol 2e-4 of one process's and
  of tpucv's ``jax.value_and_grad``. On (1, 4) the last conv sees one row
  a rank, with a halo from each neighbour.
- YOLOv8n in train mode (``enable_spatial``: 1x1 and 3x3 convs at stride
  1 and 2, SPPF's 5x5 max pools, nearest upsampling and concatenation,
  BatchNorm over data x model) at 256², B=2: the head's maps gathered,
  the summed mean squares, against one process: outputs within rtol /
  atol 2e-4, the loss within 1e-5 relative, BatchNorm statistics within
  1e-5; the gradients, which train-mode BatchNorm makes ill-conditioned,
  within twice the share of each tensor's largest element by which one
  process's own f32 gradients part from its float64 ones (on some inputs
  that share reaches 4.8e-3, as ``GRAD_SHARE`` in
  ``test_torch_parallel.py`` records for data parallelism), never
  tighter than 2e-4 and never looser than ``GRAD_SHARE_CEIL``, 1e-2. At
  (1, 4) SPPF sees two rows a rank, its halo.
- A local height that is odd before a stride-2 layer, or smaller than a
  halo, is refused with a message.
- tpucv's ``test_batch_sharded_inference_matches_single_device``
  (``:332-365``: YOLOv8n at 64², nc 8, ``pre_nms_topk`` 64, ``max_det``
  16, conf 0.05), the class branch sharpened so that scores spread:
  ``valid`` and classes equal to one process's and to tpucv's
  ``make_infer_fn``'s on the same weights, scores within rtol 1e-5 / atol
  1e-6 and boxes within rtol 1e-4 / atol 1e-3 (that test's tolerances).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_dp_workers as W
from test_torch_ssd import numpy_sd
from tpucv.algorithms.yolov8 import YOLOv8 as JYOLOv8
from tpucv.ckpt.importer import import_yolov8
from tpucv.configs.model_cfgs import Yolo8DetConfig as JYolo8DetConfig
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.nn.blocks import GroupRef
from tpucv_torch.parallel import spatial as sp

torch.set_num_threads(1)
WORLD = 4
SHAPES = [(2, 2), (1, 4)]
CLS_GAIN = 3000.0
GRAD_SHARE_CEIL = 1e-2   # twice the largest one-process share measured


class JNet(fnn.Module):
    """tpucv's net of ``test_spatial_partitioning_matches_replicated``."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(8, (3, 3), strides=2, padding="SAME")(x)
        x = fnn.relu(x)
        x = fnn.Conv(16, (3, 3), strides=2, padding="SAME")(x)
        x = fnn.avg_pool(x, (2, 2), (2, 2))
        return fnn.Conv(16, (3, 3), padding="SAME")(x)


def port_weights(params):
    return {f"{mod}.{'weight' if leaf == 'kernel' else leaf}":
            torch.from_numpy(np.ascontiguousarray(
                np.transpose(np.asarray(v), (3, 2, 0, 1))
                if np.ndim(v) == 4 else np.asarray(v)))
            for mod, leaves in params.items() for leaf, v in leaves.items()}


def _as_net_names(g):
    """``Conv_i.weight`` / ``Conv_i.bias`` -> ``SpatialNet``'s ``wi`` /
    ``bi``."""
    return {("w" if k.endswith("weight") else "b") + k[5]: v
            for k, v in g.items()}


def sharpened_det_model():
    """The port's seed-0 YOLOv8n (nc 8) with the class branch's biases
    zeroed and its last kernels scaled by CLS_GAIN."""
    algo = W.det_algo()
    model = algo.init_variables(seed=0)
    with torch.no_grad():
        for head in model.model[22].cv3:
            head[-1].bias.zero_()
            head[-1].weight.mul_(CLS_GAIN)
    return algo, model


def tpucv_infer(sd, imgs):
    cfg = JYolo8DetConfig()
    cfg.dataset.input_size = 64
    cfg.train.mixed_precision = False
    cfg.decode.pre_nms_topk = 64
    cfg.decode.max_det = 16
    algo = JYOLOv8(cfg)
    algo.nc = 8
    infer = algo.make_infer_fn(conf_threshold=0.05)
    return [np.asarray(t) for t in jax.device_get(
        infer(import_yolov8(sd), jnp.asarray(imgs)))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    variables = JNet().init(jax.random.PRNGKey(0), x)
    weights = port_weights(variables["params"])
    yolo = W.yolo_spatial_model(Yolo8("n", nc=80).reset_parameters(
        torch.Generator().manual_seed(0)).state_dict())
    yolo_sd = {k: v.clone() for k, v in yolo.state_dict().items()}
    yolo_x = np.random.default_rng(1).random((2, 256, 256, 3),
                                             dtype=np.float32)
    algo, det = sharpened_det_model()
    det_sd = {k: v.clone() for k, v in det.state_dict().items()}
    imgs = np.random.default_rng(0).integers(0, 255, (8, 64, 64, 3),
                                             dtype=np.uint8)
    ranks = W.Ranks(W.case_spatial_world, WORLD, tmp, shapes=SHAPES,
                    spatial={"spatial_weights": weights, "x": x,
                             "yolo_sd": yolo_sd, "yolo_x": yolo_x},
                    det_sd=det_sd, imgs=imgs)
    one = {"net": W.spatial_run(W.SpatialNet(weights), x, None,
                                lambda o: o.square().sum(),
                                W.spatial_net_forward),
           "yolo": W.spatial_run(copy.deepcopy(yolo), yolo_x, None,
                                 W.maps_loss, W.yolo_forward),
           "yolo64": W.spatial_run(yolo.double(), yolo_x.astype(np.float64),
                                   None, W.maps_loss, W.yolo_forward),
           "infer": [t.numpy() for t in algo.make_infer_fn(
               conf_threshold=0.05)(det, torch.from_numpy(imgs))],
           "tpucv_infer": tpucv_infer(numpy_sd(det), imgs)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda v, xx: jnp.sum(JNet().apply(v, xx) ** 2)))(variables, x)
    one["tpucv_net"] = (float(loss), _as_net_names(
        port_weights(jax.device_get(grads)["params"])))
    return {"out": ranks.results(), "one": one}


def _grads_close(got, ref, tol=2e-4):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_spatial_net_matches_one_process_and_tpucv(world, shape):
    ref = world["one"]["net"]
    j_loss, j_grads = world["one"]["tpucv_net"]
    for r in world["out"]:
        got = r[shape]["spatial"]["net"]
        assert abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) < 1e-5
        assert abs(got["loss"] - j_loss) / abs(j_loss) < 1e-5
        _grads_close(got["grads"], ref["grads"])
        _grads_close(got["grads"], j_grads)
        np.testing.assert_allclose(got["out"][0].numpy(),
                                   ref["out"][0].numpy(), rtol=2e-4,
                                   atol=2e-4)


def _share(got, ref64):
    """The largest |got - ref| over each tensor's largest |ref|."""
    return max(float((got[k].double() - v).abs().max() / v.abs().max())
               for k, v in ref64.items())


@pytest.mark.parametrize("shape", SHAPES)
def test_spatial_yolo8_matches_one_process(world, shape):
    ref, ref64 = world["one"]["yolo"], world["one"]["yolo64"]
    bound = min(max(2 * _share(ref["grads"], ref64["grads"]), 2e-4),
                GRAD_SHARE_CEIL)
    for r in world["out"]:
        got = r[shape]["spatial"]["yolo"]
        assert abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) < 1e-5
        for a, b in zip(got["out"], ref["out"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-4)
        assert got["grads"].keys() == ref64["grads"].keys()
        assert _share(got["grads"], ref64["grads"]) <= bound
        _grads_close(got["stats"], ref["stats"], 1e-5)


def test_spatial_refuses_heights_it_cannot_split():
    split = sp.HeightSplit(2, 0, GroupRef())
    x = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="does not divide the stride 2"):
        sp.conv2d(x, torch.zeros(4, 4, 3, 3), None, 2, (1, 1), (1, 1),
                  split)
    with pytest.raises(ValueError, match="smaller than the halo"):
        sp.max_pool2d(torch.zeros(1, 4, 1, 8), 5, 1, 2, split)
    with pytest.raises(ValueError, match="does not split over 2"):
        sp.split_height(torch.zeros(1, 5, 8, 3), split)


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_sharded_inference_matches_one_process_and_tpucv(world,
                                                              shape):
    ref = world["one"]["infer"]
    j_ref = world["one"]["tpucv_infer"]
    assert ref[3].sum() >= 8 * 8          # the slates hold detections
    for r in world["out"]:
        b_o, s_o, c_o, v_o = (t.numpy() for t in r[shape]["infer"])
        for b_r, s_r, c_r, v_r in (ref, j_ref):
            np.testing.assert_array_equal(v_r, v_o)
            np.testing.assert_array_equal(c_r[v_r], c_o[v_o])
            np.testing.assert_allclose(s_r[v_r], s_o[v_o], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(b_r[v_r], b_o[v_o], rtol=1e-4,
                                       atol=1e-3)
