"""tpucv_torch NMS engines against tpucv's.

The kernel's plain version (``nms_keep_reference``) and its wrapper
``cuda_nms`` on CPU tensors are held against tpucv's Pallas kernel in
interpret mode, the scan ``nms`` and ``nms_fixpoint`` on every case of
``tests/test_pallas_nms.py`` plus class-offset sets at B=4, K=512. Keep-sets
must be identical. The CUDA kernel itself is held against its plain
version in ``tests/test_torch_cuda.py``, which needs a card.

The YOLO-style ``non_max_suppression`` and ``batched_non_max_suppression``
(and ``batched_single_label_nms`` with ``xywh=True``) are held against
tpucv's on ``nms_cases.yolo_pred_case`` (clustered boxes, tied scores,
exact duplicates, tied best classes) at K = 32, 1,024 and 2,048,
class-aware and agnostic: every output equal, boxes and scores bit for
bit. The batch goes through ``dispatch_batched_nms`` once: ``cuda_nms``
(the kernel's route) at K <= 1,024, the scan at 2,048.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from tpucv.ops import nms as jax_nms_mod
from tpucv.ops.nms import (dispatch_batched_nms as jax_dispatch,
                           nms as jax_nms, nms_fixpoint as jax_fixpoint)
from tpucv.ops.pallas_nms import pallas_nms
from tpucv_torch.ops.cuda_nms import cuda_nms, nms_keep, nms_keep_reference
from tpucv_torch.ops import nms as nms_mod
from tpucv_torch.ops.nms import (batched_nms, batched_non_max_suppression,
                                 batched_single_label_nms,
                                 dispatch_batched_nms, nms, nms_fixpoint,
                                 non_max_suppression)
from tpucv_torch.ops.nms_cases import (chain_keep, class_offset_case,
                                       greedy_cases, presorted_case,
                                       yolo_pred_case)

torch.set_num_threads(1)

CASES = {
    **greedy_cases(),
    "offsets_iou0.5": (class_offset_case(0, 4, 512), 0.5),
    "offsets_iou0.7": (class_offset_case(1, 4, 512), 0.7),
}
MAX_DET = {"batched": 32, "presorted": 30}


def _keep_sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [sorted(idx[b][valid[b]].tolist()) for b in range(idx.shape[0])]


@pytest.mark.parametrize("name", list(CASES))
def test_port_engines_match_pallas_and_greedy(name):
    (boxes, scores), thr = CASES[name]
    max_det = MAX_DET.get(name, min(boxes.shape[1], 300))
    ref = _keep_sets(*pallas_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 thr, max_det, interpret=True))
    for b in range(boxes.shape[0]):
        scan = _keep_sets(*(x[None] for x in jax_nms(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr, max_det)))
        fix = _keep_sets(*(x[None] for x in jax_fixpoint(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr, max_det)))
        assert scan[0] == fix[0] == ref[b], (name, b)

    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    assert _keep_sets(*cuda_nms(tb, ts, thr, max_det)) == ref
    for b in range(boxes.shape[0]):
        assert _keep_sets(*(x[None] for x in nms(tb[b], ts[b], thr,
                                                 max_det)))[0] == ref[b]
        assert _keep_sets(*(x[None] for x in nms_fixpoint(
            tb[b], ts[b], thr, max_det)))[0] == ref[b]


def test_chains_keep_every_second_box():
    for name in ("chain60", "chain120"):
        (boxes, scores), thr = CASES[name]
        keep = nms_keep_reference(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), thr)
        assert np.flatnonzero(keep[0].numpy()).tolist() == chain_keep(name)


def test_presorted_matches_unsorted_path():
    boxes, scores = presorted_case()
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    assert _keep_sets(*cuda_nms(tb, ts, 0.5, 30)) == \
        _keep_sets(*cuda_nms(tb, ts, 0.5, 30, presorted=True))


def test_diou_scan_matches_tpucv():
    (boxes, scores), _ = CASES["seed3"]
    for thr in (0.3, 0.5):
        ref = jax_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), thr, 64,
                      diou=True)
        out = nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                  thr, 64, diou=True)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


def test_batched_nms_class_aware():
    rng = np.random.default_rng(4)
    (boxes, scores), _ = CASES["seed4"]
    cls = rng.integers(0, 3, boxes.shape[1])
    idx, valid = batched_nms(torch.from_numpy(boxes[0]),
                             torch.from_numpy(scores[0]),
                             torch.from_numpy(cls), 0.5, 128)
    from tpucv.ops.nms import batched_nms as jax_batched
    ref = jax_batched(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                      jnp.asarray(cls), 0.5, 128)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("K", [512, 1536])
def test_dispatch_matches_tpucv(K):
    """K <= 1024 takes the kernel's route (its plain version on CPU),
    K > 1024 the scan; both equal tpucv's dispatch exactly."""
    boxes, scores = class_offset_case(2, B=2, K=K)
    ref = jax_dispatch(jnp.asarray(boxes), jnp.asarray(scores), 0.7, 300,
                       use_pallas=False)
    out = dispatch_batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 0.7, 300)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


def test_wrapper_validates_inputs():
    b = torch.zeros(2, 8, 4)
    s = torch.ones(2, 8)
    with pytest.raises(TypeError):
        nms_keep(b.double(), s.double())
    with pytest.raises(ValueError):
        nms_keep(b[:, :, :3], s)
    with pytest.raises(ValueError):
        nms_keep(b.transpose(0, 1).contiguous().transpose(0, 1), s)
    before = nms_keep.launches
    nms_keep(b, s)                         # CPU: plain version, no launch
    assert nms_keep.launches == before


# ---------------------------------------------- YOLO-style decode-and-NMS
YOLO_K = {32: (600, 32), 1024: (1500, 1024), 2048: (3000, 2048)}  # K: A, topk


def _assert_equal(got, ref):
    """Every output equal; the classes where valid (an empty slot's class
    is whichever index the engine's search ended on: the scan's and the
    fixpoint's part)."""
    valid = np.asarray(ref[3])
    assert valid.any()
    np.testing.assert_array_equal(got[3].numpy(), valid)
    for name, g, r in zip(("boxes", "scores"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_array_equal(got[2].numpy()[valid],
                                  np.asarray(ref[2])[valid])


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("K", list(YOLO_K))
def test_batched_non_max_suppression_equals_tpucv(K, agnostic,
                                                  monkeypatch):
    A, topk = YOLO_K[K]
    pred = yolo_pred_case(K, 2, A, nc=8)
    max_det = min(300, K)                # tpucv's top_k needs max_det <= K
    ref = jax.jit(lambda p: jax_nms_mod.batched_non_max_suppression(
        p, 0.25, 0.45, max_det, topk, agnostic))(jnp.asarray(pred))
    calls = []
    real = nms_mod.cuda_nms
    monkeypatch.setattr(nms_mod, "cuda_nms",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = batched_non_max_suppression(torch.from_numpy(pred), 0.25, 0.45,
                                      max_det, topk, agnostic)
    _assert_equal(got, ref)
    assert len(calls) == (1 if K <= 1024 else 0)


@pytest.mark.parametrize("K", [32, 2048])
def test_non_max_suppression_equals_tpucv(K):
    A, topk = YOLO_K[K]
    pred = yolo_pred_case(K + 1, 1, A, nc=8)[0]
    max_det = min(300, K)
    ref = jax.jit(lambda p: jax_nms_mod.non_max_suppression(
        p, 0.25, 0.45, max_det, topk))(jnp.asarray(pred))
    got = non_max_suppression(torch.from_numpy(pred), 0.25, 0.45, max_det,
                              topk)
    _assert_equal(got, ref)


@pytest.mark.parametrize("agnostic", [False, True])
def test_batched_single_label_nms_xywh_equals_tpucv(agnostic):
    pred = yolo_pred_case(5, 2, 900, nc=8)
    ref = jax_nms_mod.batched_single_label_nms(
        jnp.asarray(pred), 0.2, 0.6, 50, 512, class_agnostic=agnostic,
        use_pallas=False, xywh=True)
    got = batched_single_label_nms(torch.from_numpy(pred), 0.2, 0.6, 50,
                                   512, class_agnostic=agnostic, xywh=True)
    _assert_equal(got, ref)
