"""Evaluate CLI (counterpart of the root ``evaluate.py``), with the same
flags plus ``--device``:

    python -m tpucv_torch.evaluate --model yolo8_det --dataset coco \\
        --ckpt <path> [--subset val] [--batch-size 32] [--plots]

Runs on CUDA unless ``--device cpu`` is given; on a machine without CUDA
it stops with an error rather than moving to the CPU. The dataset is read
through the algorithm's ``build_eval_index`` from the dataset's root
(``TPUCV_COCO_ROOT`` / ``TPUCV_VOC_ROOT`` point it elsewhere; the
classifiers read a folder-per-class tree at ``TPUCV_CLS_ROOT`` and print
top-1 / top-5); COCO detections are written to
``result/eval_results.json`` in the working directory, VOC plots
(``--plots``) to ``result/plots``. ``--int8`` calibrates on the first 32
images of the eval index and evaluates the quantized model
(``tpucv_torch/quant.py``); the classifiers refuse it.
"""

from __future__ import annotations

import argparse

from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.predict import require_int8


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpucv_torch.evaluate")
    parser.add_argument("--model", type=str, required=True,
                        help="yolo8_det, yolo8_seg, yolo8_pose, yolo8_cls, "
                             "yolo7, ssd, centernet, deeplabv3plus or "
                             "vit_cls")
    parser.add_argument("--dataset", type=str, default=None,
                        choices=["voc", "coco"])
    parser.add_argument("--ckpt", type=str, default="",
                        help="a trainer checkpoint bundle, or a torch "
                             "state_dict with ultralytics key names")
    parser.add_argument("--subset", type=str, default="val")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--plots", action="store_true",
                        help="write the per-class AP bar chart and PR "
                             "curves (VOC protocol only; needs matplotlib)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' must be asked for")
    parser.add_argument("--int8", action="store_true",
                        help="post-training int8 quantization: calibrate on "
                             "the first eval images, then run the int8 "
                             "inference path (tpucv_torch/quant.py)")
    args = parser.parse_args(argv)

    cfg, algo_cls, _ = export_from_registry(args.model)
    if args.dataset:
        cfg.dataset.name = args.dataset
    algo = algo_cls(cfg, device=args.device)
    if args.int8:
        require_int8(algo, args.model)
    model = algo.init_variables()
    if args.ckpt:
        model.load_state_dict(CheckPoint.load_pure(args.ckpt))

    index = algo.build_eval_index(args.subset)
    if args.int8:
        model = algo.quantize_variables(model, index)
    kw = {"plots": True} if args.plots else {}
    return algo.run_eval(model, index, args.batch_size, **kw)


if __name__ == "__main__":
    main()
