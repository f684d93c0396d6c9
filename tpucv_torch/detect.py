"""Video detection loop (counterpart of ``scripts/detect.py``; reference
``scripts/detect.py:8-45``): each frame is letterboxed on the host and goes
through the algorithm's infer fn, with no temporary JPEG per frame; and
the first frames as the int8 calibration index (``predict --int8``)."""

from __future__ import annotations

import os
import time

from torch import nn

from tpucv_torch.utils.image_process import letter_box, reverse_letter_box
from tpucv_torch.utils.visualize import draw_detections


def video_calib_frames(path: str, n: int = 8):
    """The first ``n`` frames of a video (RGB) as an int8 calibration
    index."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video {path}")
    frames = []
    try:
        while len(frames) < n:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append((cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB),))
    finally:
        cap.release()
    if not frames:
        raise SystemExit(f"no decodable frames in {path}")
    return frames


def detect_video(algo, model: nn.Module, src: str,
                 dst_dir: str = "detect_results") -> str:
    """Detect on every frame of the video ``src`` and write the drawn
    frames to ``dst_dir/out_<name>`` (mp4v); returns that path."""
    import cv2
    import torch

    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {src}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    os.makedirs(dst_dir, exist_ok=True)
    out_path = os.path.join(dst_dir, "out_" + os.path.basename(src))
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))

    infer = algo.make_infer_fn()
    s = algo.input_size
    n, t0 = 0, time.time()
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            canvas, scale, pad = letter_box(frame, (s, s))
            boxes, scores, classes, valid = (
                t.cpu().numpy() for t in infer(
                    model, torch.from_numpy(canvas[None]).to(algo.device)))
            v = valid[0]
            boxes = reverse_letter_box(boxes[0][v], scale, pad,
                                       frame.shape[:2])
            drawn = draw_detections(frame, boxes, scores[0][v],
                                    classes[0][v], algo.class_names)
            n += 1
            cur_fps = n / (time.time() - t0)
            cv2.putText(drawn, f"fps: {cur_fps:.1f}", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2)
            writer.write(cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
        cap.release()
    print(f"wrote {out_path} ({n} frames, {n / (time.time() - t0):.1f} fps)")
    return out_path
