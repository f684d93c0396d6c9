"""Serve CLI — batched inference HTTP server (counterpart of ``serve.py``).

``python -m tpucv_torch.serve --model yolo8_det --ckpt yolov8n.pt --port 8080``

Runs on CUDA unless ``--device cpu`` is given; on a machine without CUDA
it stops with an error rather than moving to the CPU. ``--ckpt`` takes a
torch ``state_dict`` with the ultralytics key names (``model.{i}...``);
without it the weights are random, drawn from seed 0.

  POST /predict  (body = JPEG/PNG bytes, or raw RGB) -> detections JSON
  GET  /healthz  -> model/config
  GET  /stats    -> throughput/latency counters
"""

from __future__ import annotations

import argparse

import torch

from tpucv_torch.builder import export_from_registry
from tpucv_torch.serving import make_server


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default="",
                        help="torch state_dict with ultralytics key names")
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
    args = parser.parse_args(argv)

    cfg, algo_cls, _ = export_from_registry(args.model)
    algo = algo_cls(cfg, device=args.device)
    model = algo.init_variables()
    if args.ckpt:
        model.load_state_dict(
            torch.load(args.ckpt, map_location="cpu", weights_only=True))

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
    print(f"serving {args.model} on http://{args.host}:{args.port} "
          f"(POST /predict, GET /healthz, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.stop()
        server.server_close()


if __name__ == "__main__":
    main()
