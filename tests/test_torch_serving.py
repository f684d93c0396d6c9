"""The slice as a whole: tpucv_torch's yolo8_det serving path against
tpucv's, and the port's HTTP server.

Both packages are built through ``export_from_registry("yolo8_det")`` with
``mixed_precision=False`` and ``input_size=160``; the last test builds both
with ``mixed_precision=True``, the served default, and holds the port's
bf16 path to tpucv's own bf16 rounding. Weights are tpucv's init
with the class-branch biases zeroed (the init's -11.5..-8.8 would leave no
candidate above the 0.25 gate) and its last kernels scaled by
``CLS_GAIN``, carried across with ``from_flax_variables``. Images of several sizes go through
``_batched_detections`` of both, and through the port's server as raw RGB
(its ``/stats``: ``batch_ms``, the queue wait and each detect stage's mean).
Detection counts and classes must match exactly, boxes within 1e-2 px of
the original image, scores within 1e-5.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.decode.yolov8 import topk_candidates
from tpucv_torch.ops.preprocess import letterbox_images, normalize_images
from tpucv_torch.serving import make_server

torch.set_num_threads(1)

SIZES = [(480, 640), (427, 640), (300, 500), (480, 640)]
BATCH = 4
CLS_GAIN = 3000.0


def _images():
    rng = np.random.default_rng(0)
    imgs = []
    for h, w in SIZES:
        # smooth gradients + noise: structured enough for varied scores
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h,
                         (xx + yy) * 255 // (h + w)], -1)
        noise = rng.integers(-40, 41, (h, w, 3))
        imgs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return imgs


def _tpucv_algo(mixed_precision):
    cfg, algo_cls, _ = tpucv_export("yolo8_det")
    cfg.train.mixed_precision = mixed_precision
    cfg.dataset.input_size = 160
    return algo_cls(cfg)


def _port(variables, mixed_precision):
    pcfg, palgo_cls, trainer = export_from_registry("yolo8_det")
    assert trainer.__name__ == "Yolo8Trainer"
    pcfg.train.mixed_precision = mixed_precision
    pcfg.dataset.input_size = 160
    palgo = palgo_cls(pcfg, device="cpu")
    model = palgo.init_variables()
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return palgo, model


def _variables(algo):
    variables = algo.init_variables()
    params = {k: dict(v) for k, v in variables["params"].items()}
    for lv in range(3):
        cls_head = dict(params["detect"][f"cv3_{lv}_2"])
        cls_head["bias"] = np.zeros_like(cls_head["bias"])
        # the init's logits are ~1e-4, so scores would sit within an f32
        # ulp of 0.5 and tie; scaled up they spread over (0.25, 0.75)
        cls_head["kernel"] = np.asarray(cls_head["kernel"]) * CLS_GAIN
        params["detect"][f"cv3_{lv}_2"] = cls_head
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def both():
    algo = _tpucv_algo(False)
    variables = _variables(algo)
    palgo, model = _port(variables, False)
    index = [(img,) for img in _images()]
    ref = list(algo._batched_detections(variables, index, BATCH, 0.25))
    return palgo, model, index, ref


def _assert_same(ref, boxes, scores, classes):
    _, rb, rs, rc = ref
    assert len(classes) == len(rc)
    np.testing.assert_array_equal(np.asarray(classes), rc)
    np.testing.assert_allclose(np.asarray(boxes, np.float32), rb, atol=1e-2,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(scores, np.float32), rs, atol=1e-5,
                               rtol=0)


def test_batched_detections_match_tpucv(both):
    palgo, model, index, ref = both
    out = list(palgo._batched_detections(model, index, BATCH, 0.25))
    assert [o[0] for o in out] == list(range(len(SIZES)))
    for o, r in zip(out, ref):
        _assert_same(r, *o[1:])
    assert all(len(r[3]) > 0 for r in ref)

    # NMS had work to do: valid candidates > 0 and kept < valid
    with torch.no_grad(), palgo._staged_batch(index, range(BATCH), BATCH) \
            as (canvases, hw, geom, hscale, _, _):
        lb, _, _ = letterbox_images(canvases, hw, palgo.input_size,
                                    geom=geom, scale=hscale)
        raw = model(normalize_images(lb, torch.float32))
        _, scores, _ = topk_candidates(raw, pre_nms_topk=1024)
    n_valid = (scores > 0).sum(1).tolist()
    kept = [len(r[3]) for r in ref]
    assert all(v > 0 for v in n_valid)
    assert any(k < v for k, v in zip(kept, n_valid))


def test_http_raw_rgb_matches_tpucv(both):
    palgo, model, index, ref = both
    server = make_server(palgo, model, host="127.0.0.1", port=0,
                         batch_size=BATCH, max_wait_ms=1.0,
                         model_name="yolo8_det")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        for (img,), r in zip(index, ref):
            h, w = img.shape[:2]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=img.tobytes(),
                headers={"Content-Type": "application/x-raw-rgb",
                         "X-Height": str(h), "X-Width": str(w)})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                dets = json.loads(resp.read())["detections"]
            _assert_same(r, [d["box"] for d in dets],
                         [d["score"] for d in dets],
                         [d["class_id"] for d in dets])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["requests"] == len(SIZES) and stats["errors"] == 0
        assert stats["batch_ms"] > 0 and "device_s" not in stats
        assert stats["queue_wait_ms_p99"] <= stats["latency_ms_p99"]
        assert set(stats["stage_ms"]) == {"fill", "upload", "queue",
                                          "download", "unbox"}
    finally:
        server.shutdown()
        server.batcher.stop()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


# bf16 tolerances, from the same weights and images (tests/ at input 160,
# the CPU): the port's raw maps differed from tpucv's by 0.74-0.90x tpucv's
# own bf16-against-f32 error at each level, detection counts by at most 4
# of 197, and 96.8-98.4% of detections matched by class at IoU >= 0.5
BF16_MAP_MULTIPLE = 2.0      # port-vs-tpucv bf16, over tpucv's bf16-vs-f32
BF16_COUNT_FRACTION = 0.03   # |count difference| over tpucv's count
BF16_MATCHED_FRACTION = 0.9  # matched detections over the larger count
BF16_MATCH_IOU = 0.5


def _iou(a, b):
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) -
                 np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) -
                 np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def _matched(ref, out):
    """Greedy one-to-one matches, tpucv's detections by score: the port's
    best unmatched detection of the same class at IoU >= BF16_MATCH_IOU."""
    _, rb, rs, rc = ref
    _, ob, _, oc = out
    sim = _iou(np.asarray(rb), np.asarray(ob)) * \
        (np.asarray(rc)[:, None] == np.asarray(oc)[None])
    used, n = set(), 0
    for i in np.argsort(-np.asarray(rs), kind="stable"):
        for j in np.argsort(-sim[i], kind="stable"):
            if sim[i, j] < BF16_MATCH_IOU:
                break
            if j not in used:
                used.add(j)
                n += 1
                break
    return n


def test_bf16_served_path_within_tpucvs_own_bf16_error():
    """``mixed_precision = True`` on both sides: tpucv computes in bf16,
    the port under bf16 autocast, so they round at other places. Each
    level's raw maps stay within BF16_MAP_MULTIPLE x tpucv's own
    bf16-against-f32 error on the same letterboxed images, and the served
    detections agree in count and, matched by class and IoU, in place."""
    from tpucv.ops.preprocess import normalize_images as tpucv_normalize

    a32, a16 = _tpucv_algo(False), _tpucv_algo(True)
    variables = _variables(a32)
    palgo, model = _port(variables, True)
    index = [(img,) for img in _images()]

    with torch.inference_mode(), palgo._staged_batch(
            index, range(BATCH), BATCH) as (canvases, hw, geom, hscale, _, _):
        lb, _, _ = letterbox_images(canvases, hw, palgo.input_size,
                                    geom=geom, scale=hscale)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            port = model(normalize_images(lb, torch.bfloat16))
    u8 = jnp.asarray(lb.numpy())
    f32 = a32.build_model().apply(variables, tpucv_normalize(u8, jnp.float32))
    b16 = a16.build_model().apply(variables,
                                  tpucv_normalize(u8, jnp.bfloat16))
    for lv, (p, f, b) in enumerate(zip(port, f32, b16)):
        f, b = np.asarray(f, np.float32), np.asarray(b, np.float32)
        own = np.abs(b - f).max()
        diff = np.abs(p.float().numpy() - b).max()
        assert 0 < own and diff <= BF16_MAP_MULTIPLE * own, (lv, diff, own)

    ref = list(a16._batched_detections(variables, index, BATCH, 0.25))
    out = list(palgo._batched_detections(model, index, BATCH, 0.25))
    assert [o[0] for o in out] == [r[0] for r in ref]
    for r, o in zip(ref, out):
        n_ref, n_out = len(r[3]), len(o[3])
        assert n_ref > 0
        assert abs(n_out - n_ref) <= BF16_COUNT_FRACTION * n_ref, \
            (n_ref, n_out)
        assert _matched(r, o) >= BF16_MATCHED_FRACTION * max(n_ref, n_out)


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    with pytest.raises(RuntimeError, match="CUDA"):
        algo_cls(cfg)
    from tpucv_torch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "yolo8_det"])
