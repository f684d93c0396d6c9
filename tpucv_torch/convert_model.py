"""Model converter CLI (counterpart of the root ``convert_model.py``):

    python -m tpucv_torch.convert_model --model yolo8_det --src <in> \\
        --dst <out> [--int8 [--calib-dir <images>]] [--device cuda]

``--src`` is a trainer bundle (its weights extracted, ``CheckPoint.
load_pure``) or a torch ``.pt`` / ``.pth`` (a module, ``{"model":
module}``, ``{"state_dict": ...}`` or a bare state_dict), whose weights
load into the port's model strictly: the port keeps the reference's key
names, so no importer maps them. Only ``yolo8_det`` and ``yolo7`` are
taken from a ``.pt``, as tpucv's converter takes them. ``--dst`` gets
the model's ``state_dict`` (``CheckPoint.save_pure``), which the predict,
evaluate and serve CLIs take as ``--ckpt``. With ``--int8`` the weights
are then calibrated on ``--calib-dir``'s images, or on 16 synthetic
detection images (seed 7), and ``--dst`` gets the quantized model's
``state_dict``: those CLIs load it quantized and run the int8 path
(``tpucv_torch/quant.py``). The model is built on ``--device`` (CUDA
unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.predict import require_int8

TORCH_IMPORTS = ("yolo7", "yolo8_det")
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _algo(model_name: str, device: str):
    cfg, algo_cls, _ = export_from_registry(model_name)
    return cfg, algo_cls(cfg, device=device)


def extract_from_checkpoint(model_name: str, ckpt_path: str, out_path: str,
                            device: str = "cuda") -> str:
    """A trainer bundle (or a pure weights file) -> pure weights, loaded
    into the family's model first, strictly."""
    model = _algo(model_name, device)[1].init_variables()
    model.load_state_dict(CheckPoint.load_pure(ckpt_path))
    CheckPoint.save_pure(model, out_path)
    print(f"wrote {out_path}")
    return out_path


def torch_state_dict(obj) -> dict:
    """The state_dict inside what ``torch.load`` returned: a module's, a
    ``{"model": module}`` checkpoint's (as float), a ``{"state_dict":
    ...}`` dict's or the dict itself."""
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if isinstance(obj, dict) and hasattr(obj.get("model"), "state_dict"):
        return obj["model"].float().state_dict()
    if isinstance(obj, dict):
        return obj.get("state_dict", obj)
    raise TypeError(f"no state_dict in a {type(obj).__name__}")


def extract_weights_from_torch_model(model_name: str, pt_path: str,
                                     out_path: str,
                                     device: str = "cuda") -> str:
    """A torch ``.pt`` / ``.pth`` -> pure port weights."""
    if model_name not in TORCH_IMPORTS:
        raise NotImplementedError(
            f"torch import supports {sorted(TORCH_IMPORTS)}; other families "
            "load tpucv checkpoints directly")
    # a pickled module needs the full unpickler, as tpucv's converter uses
    obj = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in torch_state_dict(obj).items()}
    model = _algo(model_name, device)[1].init_variables()
    model.load_state_dict(sd, strict=True)
    CheckPoint.save_pure(model, out_path)
    print(f"wrote {out_path}")
    return out_path


def calibration_index(cfg, calib_dir: str = ""):
    """``calib_dir``'s images as an index (``[i][0]`` a path), or the
    synthetic detection set tpucv's converter calibrates on."""
    if calib_dir:
        paths = sorted(p for p in glob.glob(os.path.join(calib_dir, "*"))
                       if p.lower().endswith(IMAGE_EXTS))
        if not paths:
            raise SystemExit(f"no images found in {calib_dir!r}")
        return [(p,) for p in paths]
    from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex
    print("no --calib-dir given — calibrating on synthetic data")
    return SyntheticDetectionIndex(16, cfg.dataset.input_size,
                                   cfg.num_classes, max_objects=3, seed=7)


def quantize_checkpoint(model_name: str, weights_path: str, out_path: str,
                        calib_dir: str = "", device: str = "cuda") -> str:
    """Pure weights -> an int8 deploy file: calibrated once, the
    quantized model's state_dict saved."""
    cfg, algo = _algo(model_name, device)
    require_int8(algo, model_name)
    model = algo.init_variables()
    model.load_state_dict(CheckPoint.load_pure(weights_path))
    index = calibration_index(cfg, calib_dir)
    qmodel = algo.quantize_variables(model, index,
                                     n_images=min(32, len(index)))
    n = quant.count_quantized(qmodel)
    CheckPoint.save_pure(qmodel, out_path)
    print(f"wrote {out_path} ({n} convs int8)")
    return out_path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="python -m tpucv_torch.convert_model")
    ap.add_argument("--model", required=True)
    ap.add_argument("--src", required=True,
                    help="a trainer checkpoint, or a torch .pt / .pth")
    ap.add_argument("--dst", required=True, help="output weights file")
    ap.add_argument("--int8", action="store_true",
                    help="also calibrate and quantize: write an int8 "
                         "deploy file (calibrated on --calib-dir images or "
                         "synthetic data)")
    ap.add_argument("--calib-dir", default="",
                    help="directory of calibration images for --int8")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    if args.src.endswith((".pt", ".pth")):
        extract_weights_from_torch_model(args.model, args.src, args.dst,
                                         args.device)
    else:
        extract_from_checkpoint(args.model, args.src, args.dst, args.device)
    if args.int8:
        quantize_checkpoint(args.model, args.dst, args.dst, args.calib_dir,
                            args.device)
    return args.dst


if __name__ == "__main__":
    main()
