"""VOC-style per-class AP / mAP engine (counterpart of
``tpucv/metrics/voc_map.py``).

The Cartucho/mAP engine the reference uses (``core/metrics/mAP.py:302-835``:
per-class greedy matching at a single IoU threshold, monotone-envelope AP
integration ``voc_ap`` :107-155) as in-memory numpy, with no GT/DR txt
directory round trip.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Exact AP by monotone envelope + step integration
    (reference mAP.py:107-155)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def evaluate_voc_map(
    gts: Sequence[dict],
    dts: Sequence[dict],
    class_names: Sequence[str],
    iou_threshold: float = 0.5,
    legacy_onepix: bool = True,
) -> Dict:
    """Compute per-class AP + mAP at one IoU threshold.

    gts: {image_id, class_id, bbox xyxy, difficult(bool, optional)}
    dts: {image_id, class_id, bbox xyxy, score}
    Difficult GTs are ignored (not counted, matches don't count as FP) —
    same convention as the reference engine.

    legacy_onepix reproduces the reference engine's classic VOC +1 pixel
    convention (``iw = bi[2]-bi[0]+1`` etc, mAP.py:495-501): widths/heights
    get +1 in both intersection and areas. Default ON so published numbers
    match the reference bit-for-bit; pass False for the continuous
    convention (what pycocotools uses).
    """
    n_cls = len(class_names)
    gt_by = defaultdict(list)
    for g in gts:
        gt_by[(g["image_id"], g["class_id"])].append(g)

    results = {}
    aps = []
    for c in range(n_cls):
        cls_dts = sorted([d for d in dts if d["class_id"] == c],
                         key=lambda d: -d["score"])
        # per-image matched flags
        matched: Dict = {}
        n_pos = 0
        for key, gl in gt_by.items():
            if key[1] != c:
                continue
            matched[key[0]] = np.zeros(len(gl), bool)
            n_pos += sum(1 for g in gl if not g.get("difficult", False))
        tp = np.zeros(len(cls_dts))
        fp = np.zeros(len(cls_dts))
        for di, d in enumerate(cls_dts):
            gl = gt_by.get((d["image_id"], c), [])
            if not gl:
                fp[di] = 1
                continue
            g_boxes = np.array([g["bbox"] for g in gl], float)
            db = np.asarray(d["bbox"], float)
            off = 1.0 if legacy_onepix else 0.0
            ix = np.clip(np.minimum(db[2], g_boxes[:, 2]) -
                         np.maximum(db[0], g_boxes[:, 0]) + off, 0, None)
            iy = np.clip(np.minimum(db[3], g_boxes[:, 3]) -
                         np.maximum(db[1], g_boxes[:, 1]) + off, 0, None)
            inter = ix * iy
            union = ((db[2] - db[0] + off) * (db[3] - db[1] + off)
                     + (g_boxes[:, 2] - g_boxes[:, 0] + off)
                     * (g_boxes[:, 3] - g_boxes[:, 1] + off) - inter)
            ious = inter / np.maximum(union, 1e-9)
            gi = int(np.argmax(ious))
            if ious[gi] >= iou_threshold:
                if gl[gi].get("difficult", False):
                    continue  # ignore
                if not matched[d["image_id"]][gi]:
                    matched[d["image_id"]][gi] = True
                    tp[di] = 1
                else:
                    fp[di] = 1
            else:
                fp[di] = 1
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / max(n_pos, 1)
        prec = tp_c / np.maximum(tp_c + fp_c, np.spacing(1))
        ap = voc_ap(rec, prec) if n_pos > 0 else 0.0
        # images containing >=1 non-difficult GT of this class (the
        # reference's counter_images_per_class, mAP.py:396-401); the
        # reference passes REC into the lamr 'precision' slot (mAP.py:635)
        n_img_c = len({key[0] for key, gl in gt_by.items()
                       if key[1] == c
                       and any(not g.get("difficult", False) for g in gl)})
        lamr, _, _ = log_average_miss_rate(np.asarray(rec), fp_c, n_img_c)
        results[class_names[c]] = {
            "AP": ap, "n_gt": n_pos, "n_det": len(cls_dts),
            "precision": prec, "recall": rec, "lamr": lamr,
        }
        if n_pos > 0:
            aps.append(ap)
    mAP = float(np.mean(aps)) if aps else 0.0
    return {"mAP": mAP, "per_class": results, "iou_threshold": iou_threshold}


def log_average_miss_rate(prec: np.ndarray, fp_cumsum: np.ndarray,
                          n_images: int):
    """lamr over 9 log-spaced FPPI points — the reference's exact
    formulation (mAP.py:34-71), including its quirks: FPPI is the TRUE
    false-positive cumsum per image (a detection matched to a difficult GT
    contributes neither tp nor fp, so reconstructing fp from precision
    would inflate FPPI), and "miss rate" is the reference's 1 - precision,
    not 1 - recall.

    Returns (lamr, mr, fppi) like the reference."""
    if prec.size == 0:
        return 0.0, 1.0, 0.0
    fppi = np.asarray(fp_cumsum, float) / max(float(n_images), 1.0)
    mr = 1 - prec
    fppi_tmp = np.concatenate([[-1.0], fppi])
    mr_tmp = np.concatenate([[1.0], mr])
    refs = np.logspace(-2, 0, 9)
    ys = []
    for r in refs:
        j = np.where(fppi_tmp <= r)[0][-1]
        ys.append(mr_tmp[j])
    lamr = float(np.exp(np.mean(np.log(np.maximum(np.array(ys), 1e-10)))))
    return lamr, mr, fppi


def save_plots(result: Dict, out_dir: str):
    """AP bar chart + per-class PR curves (reference draw_plot_func,
    mAP.py:208-300)."""
    import os
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    names = sorted(result["per_class"].keys())
    aps = [result["per_class"][n]["AP"] for n in names]
    fig, ax = plt.subplots(figsize=(8, max(3, 0.3 * len(names))))
    ax.barh(names, aps)
    ax.set_xlabel("AP")
    ax.set_title(f"mAP@{result['iou_threshold']:.2f} = "
                 f"{result['mAP'] * 100:.2f}%")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "mAP.png"))
    plt.close(fig)
    fig, ax = plt.subplots()
    for n in names:
        r = result["per_class"][n]
        if len(r["recall"]):
            ax.plot(r["recall"], r["precision"], label=n, linewidth=0.8)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    if len(names) <= 25:
        ax.legend(fontsize=5)
    fig.savefig(os.path.join(out_dir, "pr_curves.png"))
    plt.close(fig)


def print_voc_map(result: Dict):
    for name, r in sorted(result["per_class"].items()):
        print(f"{r['AP'] * 100:.2f}% = {name} AP  (gt: {r['n_gt']})")
    print(f"mAP@{result['iou_threshold']:.2f} = {result['mAP'] * 100:.2f}%")
