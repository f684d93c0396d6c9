"""Train CLI (counterpart of the root ``train.py``), with the same flags
plus ``--device``:

    python -m tpucv_torch.train --model yolo8_det [--max-steps N]

Runs on CUDA unless ``--device cpu`` is given; on a machine without CUDA
it stops with an error rather than moving to the CPU. Checkpoints go to
the config's ``train.save_path`` and logs to ``log.root``, both relative
to the working directory.
"""

from __future__ import annotations

import argparse

from tpucv_torch.builder import export_from_registry


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpucv_torch.train")
    parser.add_argument("--model", type=str, required=True,
                        help="yolo8_det, yolo8_seg, yolo8_pose, yolo7, ssd, "
                             "centernet or deeplabv3plus")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--n-model", type=int, default=None,
                        help="model-axis size of tpucv's (data, model) "
                             "mesh; only 1 until the port's data "
                             "parallelism lands")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="override cfg.train.batch_size")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' must be asked for")
    args = parser.parse_args(argv)

    cfg, _algo, trainer_cls = export_from_registry(args.model)
    if args.n_model is not None:
        cfg.train.n_model = args.n_model
    if args.batch_size is not None:
        cfg.train.batch_size = args.batch_size
    trainer = trainer_cls(cfg, device=args.device)
    return trainer.train(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
