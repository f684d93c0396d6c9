"""Serve CLI — batched inference HTTP server (counterpart of ``serve.py``).

``python -m tpucv_torch.serve --model yolo8_det --ckpt yolov8n.pt --port 8080``

Runs on CUDA unless ``--device cpu`` is given; on a machine without CUDA
it stops with an error rather than moving to the CPU. ``--ckpt`` takes a
checkpoint bundle the port's trainer wrote (``*.ckpt``) or a bare torch
``state_dict`` with the ultralytics key names (``model.{i}...``), read
through ``CheckPoint.load_pure``; without it the weights are random, drawn
from seed 0. ``--int8 --calib <dir or glob>`` serves the int8 PTQ model
(``tpucv_torch/quant.py``), calibrated once at startup on the first 32
images ``--calib`` matches. ``deeplabv3plus`` is refused: the server
answers with detections, and tpucv has no segmentation server.

  POST /predict  (body = JPEG/PNG bytes, or raw RGB) -> detections JSON
  GET  /healthz  -> model/config
  GET  /stats    -> throughput/latency counters
"""

from __future__ import annotations

import argparse
import glob
import os

from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.predict import require_int8
from tpucv_torch.serving import make_server


def calib_index(pattern: str, n: int = 32):
    """The first ``n`` files of a directory or a glob, sorted, as a
    calibration index."""
    paths = sorted(
        glob.glob(os.path.join(pattern, "*")) if os.path.isdir(pattern)
        else glob.glob(pattern))[:n]
    if not paths:
        raise SystemExit(f"--calib matched no images: {pattern}")
    return [(p,) for p in paths]


def build(argv=None):
    """Parse the flags, load the model and return the server, not yet
    serving (``main`` serves it)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        help="yolo8_det, yolo8_seg, yolo8_pose, yolo7, ssd "
                             "or centernet (deeplabv3plus, vit_cls and "
                             "yolo8_cls have no serving path)")
    parser.add_argument("--ckpt", type=str, default="",
                        help="a trainer checkpoint bundle, or a torch "
                             "state_dict with ultralytics key names")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' must be asked for")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--batch", type=int, default=8,
                        help="static device batch; requests are "
                             "micro-batched up to this size")
    parser.add_argument("--max-wait-ms", type=float, default=10.0,
                        help="max time the batcher waits to fill a batch")
    parser.add_argument("--conf", type=float, default=None,
                        help="confidence threshold (default: model config)")
    parser.add_argument("--request-timeout-s", type=float, default=60.0,
                        help="per-request inference timeout (503 after)")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="queue depth beyond which requests fast-fail "
                             "503 (default: 8x batch)")
    parser.add_argument("--int8", action="store_true",
                        help="serve the int8 PTQ variant (needs --calib)")
    parser.add_argument("--calib", type=str, default="",
                        help="calibration images for --int8: a directory "
                             "or a glob")
    args = parser.parse_args(argv)

    cfg, algo_cls, _ = export_from_registry(args.model)
    if not hasattr(algo_cls, "_batched_detections"):
        raise SystemExit(
            f"{args.model} has no serving path: the server answers with "
            f"detections (_batched_detections), which a segmentation "
            f"or classification model does not give")
    algo = algo_cls(cfg, device=args.device)
    if args.int8:
        require_int8(algo, args.model)
        if not args.calib:
            raise SystemExit("--int8 needs --calib images")
    model = algo.init_variables()
    if args.ckpt:
        model.load_state_dict(CheckPoint.load_pure(args.ckpt))
    if args.int8:
        model = algo.quantize_variables(model, calib_index(args.calib))

    conf = args.conf if args.conf is not None \
        else getattr(cfg.decode, "conf_threshold", 0.25)
    print(f"warming up {args.model} serving program on {algo.device} "
          f"(batch={args.batch}, input={algo.input_size})...", flush=True)
    server = make_server(algo, model, host=args.host, port=args.port,
                         batch_size=args.batch,
                         max_wait_ms=args.max_wait_ms, conf_threshold=conf,
                         model_name=args.model,
                         request_timeout_s=args.request_timeout_s,
                         max_queue=args.max_queue)
    print(f"serving {args.model} on http://{args.host}:"
          f"{server.server_address[1]} (POST /predict, GET /healthz, "
          f"GET /stats)", flush=True)
    return server


def main(argv=None):
    server = build(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.stop()
        server.server_close()


if __name__ == "__main__":
    main()
