"""Predict CLI (counterpart of the root ``predict.py``), with the same flags
plus ``--device``:

    python -m tpucv_torch.predict --model yolo8_det --ckpt <path> \\
        --type image|video --src <paths> --dst detect_results

Runs on CUDA unless ``--device cpu`` is given; on a machine without CUDA
it stops with an error rather than moving to the CPU. ``--ckpt`` takes a
trainer bundle or a bare ``state_dict`` (``CheckPoint.load_pure``); without
it the weights are random, drawn from seed 0. Drawn images go to ``--dst``
as ``<name>@<timestamp>.jpg``.
"""

from __future__ import annotations

import argparse
import time

from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint

INT8_REFUSAL = ("--int8: int8 post-training quantization waits for the "
                "port's quant module (ROADMAP queue 1 item 12)")


def summary(result: dict) -> str:
    """One image's detections in words: objects, masks, keypoints."""
    n = len(result["boxes"])
    if not n:
        return "no detections"
    out = f"{n} objects"
    if "masks" in result:
        out += f", {n} masks"
    if "keypoints" in result:
        kv = result["keypoints"]
        out += f", {int((kv[..., 2] > 0.5).sum())} of {kv[..., 0].size} " \
               f"keypoints visible"
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpucv_torch.predict")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default="",
                        help="a trainer checkpoint bundle, or a torch "
                             "state_dict with ultralytics key names")
    parser.add_argument("--type", type=str, default="image",
                        choices=["image", "video"])
    parser.add_argument("--src", type=str, nargs="+", default=[],
                        help="input image path(s) or video path")
    parser.add_argument("--dst", type=str, default="detect_results")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' must be asked for")
    parser.add_argument("--int8", action="store_true",
                        help="int8 post-training quantization (not ported: "
                             "refused)")
    args = parser.parse_args(argv)
    if args.int8:
        raise SystemExit(INT8_REFUSAL)

    cfg, algo_cls, _ = export_from_registry(args.model)
    algo = algo_cls(cfg, device=args.device)
    model = algo.init_variables()
    if args.ckpt:
        model.load_state_dict(CheckPoint.load_pure(args.ckpt))

    if args.type == "video":
        from tpucv_torch.detect import detect_video
        if len(args.src) != 1:
            raise SystemExit("--type video takes one --src path")
        return [detect_video(algo, model, args.src[0], args.dst)]

    infer_fn = algo.make_predict_infer_fn()
    t0 = time.time()
    results = []
    for path in args.src:
        result = algo.predict(model, path, infer_fn=infer_fn,
                              save_dir=args.dst)
        print(f"{path}: {summary(result)} -> {result['saved']}")
        results.append(result)
    print(f"total time: {time.time() - t0:.2f}s")
    return results


if __name__ == "__main__":
    main()
