"""The reference's on-disk VOC evaluation format (counterpart of
``tpucv/metrics/voc_txt.py``): ``detection-results/*.txt`` and
``ground-truth/*.txt`` directories, one file an image, written and read
byte for byte as tpucv writes them, so results cross-check against
reference artifact directories.

  * a detection line: ``<class> <score[:6]> <int x1> <int y1> <int x2>
    <int y2>`` (the score's string cut to 6 characters, the coordinates
    cut to int);
  * a ground-truth line: ``<class> <x1> <y1> <x2> <y2> [difficult]``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence


def voc_image_keys(index) -> List[str]:
    """Image-id strings (file stems) for every sample of a detection index."""
    keys = []
    for i in range(len(index)):
        path = index[i][0]
        keys.append(os.path.splitext(os.path.basename(path))[0]
                    if isinstance(path, str) else f"{i:06d}")
    return keys


def export_detection_txt(dts: Sequence[dict], class_names: Sequence[str],
                         out_dir: str, image_keys: Sequence[str]):
    """Write detections ({image_id: index, class_id, bbox xyxy, score})
    as a reference-format detection-results directory."""
    os.makedirs(out_dir, exist_ok=True)
    per_img: Dict[int, List[str]] = {i: [] for i in range(len(image_keys))}
    for d in dts:
        b = d["bbox"]
        score = str(d["score"])
        per_img[d["image_id"]].append(
            f"{class_names[d['class_id']]} {score[:6]} "
            f"{int(b[0])} {int(b[1])} {int(b[2])} {int(b[3])}\n")
    for i, key in enumerate(image_keys):
        with open(os.path.join(out_dir, f"{key}.txt"), "w") as f:
            f.writelines(per_img[i])


def export_ground_truth_txt(index, out_dir: str,
                            class_names: Sequence[str]):
    """Write an index's GTs (difficult included + tagged) as a
    reference-format ground-truth directory."""
    os.makedirs(out_dir, exist_ok=True)
    keys = voc_image_keys(index)
    eval_record = getattr(index, "eval_record", None)
    for i, key in enumerate(keys):
        if eval_record is not None:
            boxes, labels, difficult = eval_record(i)
        else:
            _, boxes, labels = index[i]
            difficult = [False] * len(boxes)
        with open(os.path.join(out_dir, f"{key}.txt"), "w") as f:
            for b, l, dif in zip(boxes, labels, difficult):
                tail = " difficult" if dif else ""
                f.write(f"{class_names[int(l)]} {int(b[0])} {int(b[1])} "
                        f"{int(b[2])} {int(b[3])}{tail}\n")


def import_detection_txt(dr_dir: str,
                         class_names: Sequence[str]) -> List[dict]:
    """Read a reference detection-results dir into detection dicts
    (image_id = file stem), as the evaluators take them."""
    cls_to_id = {c: i for i, c in enumerate(class_names)}
    dts = []
    for fname in sorted(os.listdir(dr_dir)):
        if not fname.endswith(".txt"):
            continue
        stem = fname[:-4]
        with open(os.path.join(dr_dir, fname)) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                name, score = parts[0], float(parts[1])
                box = [float(v) for v in parts[2:6]]
                dts.append({"image_id": stem, "class_id": cls_to_id[name],
                            "bbox": box, "score": score})
    return dts


def import_ground_truth_txt(gt_dir: str,
                            class_names: Sequence[str]) -> List[dict]:
    """Read a reference ground-truth dir into ground-truth dicts."""
    cls_to_id = {c: i for i, c in enumerate(class_names)}
    gts = []
    for fname in sorted(os.listdir(gt_dir)):
        if not fname.endswith(".txt"):
            continue
        stem = fname[:-4]
        with open(os.path.join(gt_dir, fname)) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                difficult = parts[-1] == "difficult"
                box = [float(v) for v in (parts[1:5])]
                gts.append({"image_id": stem, "class_id": cls_to_id[parts[0]],
                            "bbox": box, "difficult": difficult})
    return gts
