"""The slice as a whole: tpucv_torch's yolo8_det serving path against
tpucv's, and the port's HTTP server.

Both packages are built through ``export_from_registry("yolo8_det")`` with
``mixed_precision=False`` and ``input_size=160``. Weights are tpucv's init
with the class-branch biases zeroed (the init's -11.5..-8.8 would leave no
candidate above the 0.25 gate) and its last kernels scaled by
``CLS_GAIN``, carried across with ``from_flax_variables``. Images of several sizes go through
``_batched_detections`` of both, and through the port's server as raw RGB.
Detection counts and classes must match exactly, boxes within 1e-2 px of
the original image, scores within 1e-5.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.decode.yolov8 import topk_candidates
from tpucv_torch.ops.preprocess import (host_letterbox_geom,
                                        letterbox_images, normalize_images)
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


@pytest.fixture(scope="module")
def both():
    cfg, algo_cls, _ = tpucv_export("yolo8_det")
    cfg.train.mixed_precision = False
    cfg.dataset.input_size = 160
    algo = algo_cls(cfg)
    variables = algo.init_variables()
    params = {k: dict(v) for k, v in variables["params"].items()}
    for lv in range(3):
        cls_head = dict(params["detect"][f"cv3_{lv}_2"])
        cls_head["bias"] = np.zeros_like(cls_head["bias"])
        # the init's logits are ~1e-4, so scores would sit within an f32
        # ulp of 0.5 and tie; scaled up they spread over (0.25, 0.75)
        cls_head["kernel"] = np.asarray(cls_head["kernel"]) * CLS_GAIN
        params["detect"][f"cv3_{lv}_2"] = cls_head
    variables = {"params": params, "batch_stats": variables["batch_stats"]}

    pcfg, palgo_cls, trainer = export_from_registry("yolo8_det")
    assert trainer is None
    pcfg.train.mixed_precision = False
    pcfg.dataset.input_size = 160
    palgo = palgo_cls(pcfg, device="cpu")
    model = palgo.init_variables()
    model.load_state_dict(from_flax_variables(variables), strict=True)
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
    canvases, hw, _, _ = palgo._fill_canvases(index, range(BATCH), BATCH,
                                              palgo.raw_canvas)
    geom, hscale = host_letterbox_geom(hw, palgo.input_size)
    with torch.no_grad():
        lb, _, _ = letterbox_images(
            torch.from_numpy(canvases), torch.from_numpy(hw),
            palgo.input_size, geom=torch.from_numpy(geom),
            scale=torch.from_numpy(hscale))
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
    finally:
        server.shutdown()
        server.batcher.stop()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    with pytest.raises(RuntimeError, match="CUDA"):
        algo_cls(cfg)
    from tpucv_torch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "yolo8_det"])
