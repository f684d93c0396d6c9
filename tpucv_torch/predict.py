"""Predict CLI (counterpart of the root ``predict.py``), with the same flags
plus ``--device``:

    python -m tpucv_torch.predict --model yolo8_det --ckpt <path> \\
        --type image|video --src <paths> --dst detect_results

Runs on CUDA unless ``--device cpu`` is given; on a machine without CUDA
it stops with an error rather than moving to the CPU. ``--ckpt`` takes a
trainer bundle or a bare ``state_dict`` (``CheckPoint.load_pure``; a
quantized model's loads quantized); without it the weights are random,
drawn from seed 0. ``--int8`` quantizes the model after calibrating it on
the ``--src`` images (batches of up to 8) or, for a video, on its first 8
frames (``tpucv_torch/quant.py``). Drawn images go to ``--dst`` as
``<name>@<timestamp>.jpg``. The classifiers (``vit_cls``, ``yolo8_cls``)
print their top-5 classes and draw nothing, and refuse ``--int8``.
"""

from __future__ import annotations

import argparse
import time

from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint



def require_int8(algo, model_name: str) -> None:
    """tpucv's refusal of ``--int8`` for an algorithm without
    ``quantize_variables``."""
    if getattr(algo, "quantize_variables", None) is None:
        raise SystemExit(f"--int8 is not supported for {model_name}")


def summary(result: dict) -> str:
    """One image's result in words: objects, masks, keypoints, a
    segmentation map, or the top three classes."""
    if "class_map" in result:
        return "segmentation map"
    if "labels" in result:              # classification: top-k names
        return "top: " + ", ".join(result["labels"][:3])
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
    parser.add_argument("--model", type=str, required=True,
                        help="yolo8_det, yolo8_seg, yolo8_pose, yolo8_cls, "
                             "yolo7, ssd, centernet, deeplabv3plus or "
                             "vit_cls")
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
                        help="post-training int8 quantization, calibrated "
                             "on the input images (tpucv_torch/quant.py)")
    args = parser.parse_args(argv)

    cfg, algo_cls, _ = export_from_registry(args.model)
    algo = algo_cls(cfg, device=args.device)
    if args.int8:
        require_int8(algo, args.model)
    model = algo.init_variables()
    if args.ckpt:
        model.load_state_dict(CheckPoint.load_pure(args.ckpt))

    if args.type == "video":
        from tpucv_torch.detect import detect_video, video_calib_frames
        if len(args.src) != 1:
            raise SystemExit("--type video takes one --src path")
        if args.int8:
            model = algo.quantize_variables(
                model, video_calib_frames(args.src[0]), n_images=8,
                batch_size=4)
        return [detect_video(algo, model, args.src[0], args.dst)]

    if args.int8:
        if not args.src:
            raise SystemExit("--int8 needs at least one --src image "
                             "to calibrate on")
        # an index is anything whose [i][0] is an image path or ndarray
        calib = [(p,) for p in args.src]
        model = algo.quantize_variables(model, calib, n_images=len(calib),
                                        batch_size=min(8, len(calib)))

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
