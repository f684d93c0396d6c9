"""COCO-style mAP, pycocotools-compatible (counterpart of
``tpucv/metrics/coco_map.py``): the bbox engine, and on its matching
hooks the segm protocol over dense masks (``COCOMaskAP``) and the
keypoints protocol (``COCOKeypointAP``, OKS).

The COCOeval bbox protocol:

  * IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1 (101 pts)
  * greedy score-ordered matching, ignore-region semantics (crowd GTs match
    via intersection-over-det-area and count as neither TP nor FP)
  * area ranges all/small/medium/large, maxDets 1/10/100
  * the standard 12-line summary (AP, AP50, AP75, APs/m/l, AR@1/10/100, ...)

``accumulate`` runs the C++ core (``tpucv_torch/native/cocoeval.cpp``) when
it builds, else the numpy engine here, which is its semantic reference.
Inputs mirror COCO json dicts: gts: {image_id, category_id, bbox xywh,
area, iscrowd}, dts: {image_id, category_id, bbox xywh, score}.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix (D, G); crowd GTs use intersection / det-area
    (pycocotools maskUtils.iou semantics for iscrowd)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    d_area = (dts[:, 2] * dts[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-9)


class COCOMeanAP:
    # protocol parameters (pycocotools Params for iouType='bbox');
    # COCOKeypointAP overrides them for the keypoints protocol
    iou_thrs = IOU_THRS
    rec_thrs = REC_THRS
    area_rng = AREA_RNG
    max_dets = MAX_DETS

    def __init__(self, gts: Sequence[dict], dts: Sequence[dict],
                 cat_ids: Sequence[int]):
        self.cat_ids = list(cat_ids)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.img_ids = set()
        for g in gts:
            self._gts[(g["image_id"], g["category_id"])].append(g)
            self.img_ids.add(g["image_id"])
        for d in dts:
            self._dts[(d["image_id"], d["category_id"])].append(d)
            self.img_ids.add(d["image_id"])
        self.img_ids = sorted(self.img_ids)

    # -------------------------------------------------- protocol hooks
    def _gt_extra_ignore(self, g: dict) -> bool:
        """Protocol-specific extra GT-ignore condition (keypoints: no
        labeled keypoints)."""
        return False

    def _dt_area(self, d: dict) -> float:
        return d["bbox"][2] * d["bbox"][3]

    @staticmethod
    def _gt_area(g: dict) -> float:
        # NOT dict.get with a default: mask gts carry "area" but no
        # "bbox", and get()'s default argument evaluates eagerly
        return g["area"] if "area" in g else g["bbox"][2] * g["bbox"][3]

    def _iou(self, dts: List[dict], gts: List[dict],
             iscrowd: np.ndarray) -> np.ndarray:
        g_boxes = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dts], float).reshape(-1, 4)
        return _iou_xywh(d_boxes, g_boxes, iscrowd)

    # ------------------------------------------------------------ matching
    def _cached_ious(self, img_id, cat_id):
        """(score-sorted dts, IoU matrix vs gts in ORIGINAL order), computed
        once per (img, cat) and reused across all area/max_det combos."""
        cache = getattr(self, "_iou_cache", None)
        if cache is None:
            cache = self._iou_cache = {}
        hit = cache.get((img_id, cat_id))
        if hit is None:
            gts = self._gts.get((img_id, cat_id), [])
            dts = self._dts.get((img_id, cat_id), [])
            d_order = np.argsort([-d["score"] for d in dts], kind="stable")
            dts_sorted = [dts[i] for i in d_order]
            iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
            hit = (dts_sorted, np.asarray(
                self._iou(dts_sorted, gts, iscrowd), float))
            cache[(img_id, cat_id)] = hit
        return hit

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gts.get((img_id, cat_id), [])
        dts = self._dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        # pycocotools ignores a gt when area < rng[0] or area > rng[1] —
        # both bounds INCLUSIVE in-range (cocoeval.evaluateImg), so an area
        # exactly on a boundary (e.g. 32^2) is in BOTH adjacent ranges
        g_ignore = np.array([
            bool(g.get("iscrowd", 0)) or self._gt_extra_ignore(g)
            or self._gt_area(g) < area_rng[0]
            or self._gt_area(g) > area_rng[1]
            for g in gts], dtype=bool)
        # sort gts: non-ignored first (pycocotools gtind ordering)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])

        # IoUs computed ONCE per (img, cat) like pycocotools computeIoU,
        # then row-sliced by max_det and column-permuted by the
        # area-dependent gt order: _iou is column-wise per gt, so
        # permutation commutes
        dts_sorted, full_ious = self._cached_ious(img_id, cat_id)
        dts = dts_sorted[:max_det]
        ious = full_ious[: len(dts)][:, g_order] if full_ious.size else \
            np.zeros((len(dts), len(gts)))

        T = len(self.iou_thrs)
        D, G = len(dts), len(gts)
        dt_m = -np.ones((T, D), int)    # matched gt index or -1
        gt_m = -np.ones((T, G), int)
        dt_ig = np.zeros((T, D), bool)
        for ti, t in enumerate(self.iou_thrs):
            for di in range(D):
                best, bestg = min(t, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_m[ti, gi] >= 0 and not iscrowd[gi]:
                        continue
                    # stop searching ignored gts once a real match was found
                    if bestg > -1 and not g_ignore[bestg] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best, bestg = ious[di, gi], gi
                if bestg == -1:
                    continue
                dt_ig[ti, di] = g_ignore[bestg]
                dt_m[ti, di] = bestg
                gt_m[ti, bestg] = di
        # unmatched dets outside the area range are ignored (same inclusive
        # bounds as gts: ignored iff area < rng[0] or area > rng[1])
        d_area = np.array([self._dt_area(d) for d in dts], float)
        d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig = dt_ig | ((dt_m == -1) & d_out[None])
        return {
            "scores": np.array([d["score"] for d in dts]),
            "dt_matched": dt_m, "dt_ignore": dt_ig,
            "num_gt": int((~g_ignore).sum()),
        }

    # -------------------------------------------------- native accumulation
    def _accumulate_native(self) -> bool:
        """Full evaluate+accumulate in C++ (native/cocoeval.cpp), the
        counterpart of pycocotools' C core. Returns False when the native
        library is unavailable (the caller falls back to numpy), or when a
        subclass customised the matching hooks the C core does not know
        (_iou/_dt_area/_gt_extra_ignore): the native path would compute the
        bbox protocol for them. Protocol PARAMETERS (iou_thrs/rec_thrs/
        area_rng/max_dets) are passed through, so overriding only those
        keeps the native path."""
        cls = type(self)
        if (cls._iou is not COCOMeanAP._iou
                or cls._dt_area is not COCOMeanAP._dt_area
                or cls._gt_extra_ignore is not COCOMeanAP._gt_extra_ignore):
            return False
        from tpucv_torch.native import load
        lib = load("cocoeval")
        if lib is None:
            return False
        import ctypes as C

        img_idx = {im: i for i, im in enumerate(self.img_ids)}
        cat_idx = {c: i for i, c in enumerate(self.cat_ids)}
        gts = [g for k, v in self._gts.items() for g in v
               if k[1] in cat_idx]
        dts = [d for k, v in self._dts.items() for d in v
               if k[1] in cat_idx]

        def arr(data, dtype):
            return np.ascontiguousarray(data, dtype=dtype)

        g_boxes = arr([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_crowd = arr([bool(g.get("iscrowd", 0)) for g in gts], np.uint8)
        g_area = arr([g.get("area", g["bbox"][2] * g["bbox"][3])
                      for g in gts], np.float64)
        g_img = arr([img_idx[g["image_id"]] for g in gts], np.int32)
        g_cat = arr([cat_idx[g["category_id"]] for g in gts], np.int32)
        d_boxes = arr([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        d_score = arr([d["score"] for d in dts], np.float64)
        d_img = arr([img_idx[d["image_id"]] for d in dts], np.int32)
        d_cat = arr([cat_idx[d["category_id"]] for d in dts], np.int32)

        # subclass-visible protocol parameters, not the module defaults
        T, R = len(self.iou_thrs), len(self.rec_thrs)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        precision = np.full((T, R, K, A, M), -1.0)
        recall = np.full((T, K, A, M), -1.0)
        area = arr([b for rng in self.area_rng.values() for b in rng],
                   np.float64)
        maxd = arr(self.max_dets, np.int32)
        iou_t = arr(self.iou_thrs, np.float64)
        rec_t = arr(self.rec_thrs, np.float64)

        p = C.POINTER(C.c_double)
        pi32 = C.POINTER(C.c_int32)
        pu8 = C.POINTER(C.c_uint8)

        def dp(a):
            return a.ctypes.data_as(p)

        lib.cocoeval_bbox(
            C.c_int(len(gts)), dp(g_boxes), g_crowd.ctypes.data_as(pu8),
            dp(g_area), g_img.ctypes.data_as(pi32), g_cat.ctypes.data_as(pi32),
            C.c_int(len(dts)), dp(d_boxes), dp(d_score),
            d_img.ctypes.data_as(pi32), d_cat.ctypes.data_as(pi32),
            C.c_int(len(self.img_ids)), C.c_int(K),
            C.c_int(T), dp(iou_t), C.c_int(R), dp(rec_t),
            C.c_int(A), dp(area), C.c_int(M), maxd.ctypes.data_as(pi32),
            dp(precision), dp(recall))
        self.precision = precision
        self.recall = recall
        return True

    # -------------------------------------------------------- accumulation
    def accumulate(self, use_native: bool | None = None):
        """use_native: True = require C++ core, False = numpy reference,
        None (default) = native when buildable, else numpy."""
        if use_native is not False and self._accumulate_native():
            return self
        if use_native is True:
            raise RuntimeError("native cocoeval library unavailable")
        T, R = len(self.iou_thrs), len(self.rec_thrs)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, (aname, arng) in enumerate(self.area_rng.items()):
                for mi, max_det in enumerate(self.max_dets):
                    evals = [self._evaluate_img(i, cat, arng, max_det)
                             for i in self.img_ids]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dt_matched"] for e in evals],
                                         axis=1)[:, order]
                    dtig = np.concatenate([e["dt_ignore"] for e in evals],
                                          axis=1)[:, order]
                    n_gt = sum(e["num_gt"] for e in evals)
                    if n_gt == 0:
                        continue
                    tps = (dtm >= 0) & ~dtig
                    fps = (dtm == -1) & ~dtig
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall
        return self

    # ------------------------------------------------------------- summary
    def _summarize(self, ap=True, iou_thr=None, area="all", max_det=100):
        ai = list(self.area_rng.keys()).index(area)
        mi = list(self.max_dets).index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
            s = s[:, :, :, ai, mi]
        else:
            s = self.recall
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        return {
            "AP": self._summarize(True),
            "AP50": self._summarize(True, 0.5),
            "AP75": self._summarize(True, 0.75),
            "APs": self._summarize(True, area="small"),
            "APm": self._summarize(True, area="medium"),
            "APl": self._summarize(True, area="large"),
            "AR1": self._summarize(False, max_det=1),
            "AR10": self._summarize(False, max_det=10),
            "AR100": self._summarize(False, max_det=100),
            "ARs": self._summarize(False, area="small"),
            "ARm": self._summarize(False, area="medium"),
            "ARl": self._summarize(False, area="large"),
        }

    def print_summary(self, stats: Dict[str, float] | None = None):
        stats = stats or self.summarize()
        rows = [
            ("0.50:0.95", "all", 100, stats["AP"], True),
            ("0.50     ", "all", 100, stats["AP50"], True),
            ("0.75     ", "all", 100, stats["AP75"], True),
            ("0.50:0.95", "small", 100, stats["APs"], True),
            ("0.50:0.95", "medium", 100, stats["APm"], True),
            ("0.50:0.95", "large", 100, stats["APl"], True),
            ("0.50:0.95", "all", 1, stats["AR1"], False),
            ("0.50:0.95", "all", 10, stats["AR10"], False),
            ("0.50:0.95", "all", 100, stats["AR100"], False),
            ("0.50:0.95", "small", 100, stats["ARs"], False),
            ("0.50:0.95", "medium", 100, stats["ARm"], False),
            ("0.50:0.95", "large", 100, stats["ARl"], False),
        ]
        for iou, area, md, v, is_ap in rows:
            kind = "Average Precision  (AP)" if is_ap else \
                   "Average Recall     (AR)"
            print(f" {kind} @[ IoU={iou} | area={area:>6s} | "
                  f"maxDets={md:>3d} ] = {v:0.3f}")


class COCOMaskAP(COCOMeanAP):
    """COCOeval iouType='segm' protocol over dense binary masks.

    gts/dts carry {"mask": bool/uint8 (H, W)} instead of RLE (masks are
    evaluated at one fixed canvas resolution, so dense arrays are exact).
    GT "area" is the mask pixel count (pycocotools semantics); crowd IoU
    uses the dt-area denominator, as bbox does. Matching and accumulation
    are COCOMeanAP's; its own ``_iou`` keeps it on the numpy engine (the
    C++ core is bbox-only, see ``COCOMeanAP._accumulate_native``).
    """

    def _dt_area(self, d: dict) -> float:
        return float(np.count_nonzero(d["mask"]))

    def _iou(self, dts, gts, iscrowd) -> np.ndarray:
        if len(dts) == 0 or len(gts) == 0:
            return np.zeros((len(dts), len(gts)))
        D = np.stack([np.asarray(d["mask"], bool).reshape(-1)
                      for d in dts]).astype(np.float32)
        G = np.stack([np.asarray(g["mask"], bool).reshape(-1)
                      for g in gts]).astype(np.float32)
        inter = D @ G.T                                   # (nd, ng)
        d_area = D.sum(axis=1, keepdims=True)
        g_area = G.sum(axis=1, keepdims=True).T
        union = np.where(iscrowd[None].astype(bool), d_area,
                         d_area + g_area - inter)
        return inter / np.maximum(union, np.spacing(1))


# COCO 17-keypoint per-joint falloff constants (pycocotools cocoeval.py
# Params.setKpParams: kpt_oks_sigmas)
OKS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


class COCOKeypointAP(COCOMeanAP):
    """COCOeval iouType='keypoints' protocol: OKS similarity, area ranges
    all/medium/large, maxDets=20, GTs with no labeled keypoints ignored.
    gts carry {keypoints (3K flat,), num_keypoints, bbox, area}; dts carry
    {keypoints (3K flat,), score}.

    pycocotools' ``computeOks``: per-joint squared distance over
    (2*sigma)^2 scaled by the GT area; for GTs with no visible joints the
    distance is to the 2x-expanded GT box. Its own matching hooks keep it
    on the numpy engine.
    """

    iou_thrs = IOU_THRS
    rec_thrs = REC_THRS
    area_rng = {"all": (0.0, 1e10), "medium": (32.0**2, 96.0**2),
                "large": (96.0**2, 1e10)}
    max_dets = (20,)

    def __init__(self, gts, dts, cat_ids, sigmas: np.ndarray = OKS_SIGMAS):
        super().__init__(gts, dts, cat_ids)
        self.sigmas = np.asarray(sigmas, float)

    def _gt_extra_ignore(self, g: dict) -> bool:
        kp = np.asarray(g["keypoints"], float)
        return int((kp[2::3] > 0).sum()) == 0

    def _dt_area(self, d: dict) -> float:
        # pycocotools loadRes: the dt area is the keypoint-extent box
        kp = np.asarray(d["keypoints"], float)
        x, y = kp[0::3], kp[1::3]
        return float((x.max() - x.min()) * (y.max() - y.min()))

    def _iou(self, dts, gts, iscrowd) -> np.ndarray:
        if len(dts) == 0 or len(gts) == 0:
            return np.zeros((len(dts), len(gts)))
        var = (self.sigmas * 2) ** 2
        ious = np.zeros((len(dts), len(gts)))
        for gi, g in enumerate(gts):
            kp = np.asarray(g["keypoints"], float)
            xg, yg, vg = kp[0::3], kp[1::3], kp[2::3]
            k1 = int((vg > 0).sum())
            bb = g["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            area = g.get("area", bb[2] * bb[3])
            for di, d in enumerate(dts):
                kd = np.asarray(d["keypoints"], float)
                xd, yd = kd[0::3], kd[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                    dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
                e = (dx**2 + dy**2) / var / (area + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[di, gi] = np.exp(-e).sum() / e.shape[0]
        return ious

    def summarize(self) -> Dict[str, float]:
        md = self.max_dets[0]
        return {
            "AP": self._summarize(True, max_det=md),
            "AP50": self._summarize(True, 0.5, max_det=md),
            "AP75": self._summarize(True, 0.75, max_det=md),
            "APm": self._summarize(True, area="medium", max_det=md),
            "APl": self._summarize(True, area="large", max_det=md),
            "AR": self._summarize(False, max_det=md),
            "AR50": self._summarize(False, 0.5, max_det=md),
            "AR75": self._summarize(False, 0.75, max_det=md),
            "ARm": self._summarize(False, area="medium", max_det=md),
            "ARl": self._summarize(False, area="large", max_det=md),
        }

    def print_summary(self, stats: Dict[str, float] | None = None):
        stats = stats or self.summarize()
        rows = [
            ("Average Precision  (AP)", "0.50:0.95", "all", stats["AP"]),
            ("Average Precision  (AP)", "0.50     ", "all", stats["AP50"]),
            ("Average Precision  (AP)", "0.75     ", "all", stats["AP75"]),
            ("Average Precision  (AP)", "0.50:0.95", "medium", stats["APm"]),
            ("Average Precision  (AP)", "0.50:0.95", "large", stats["APl"]),
            ("Average Recall     (AR)", "0.50:0.95", "all", stats["AR"]),
            ("Average Recall     (AR)", "0.50     ", "all", stats["AR50"]),
            ("Average Recall     (AR)", "0.75     ", "all", stats["AR75"]),
            ("Average Recall     (AR)", "0.50:0.95", "medium", stats["ARm"]),
            ("Average Recall     (AR)", "0.50:0.95", "large", stats["ARl"]),
        ]
        for kind, iou, area, v in rows:
            print(f" {kind} @[ OKS={iou} | area={area:>6s} | "
                  f"maxDets={self.max_dets[0]:>3d} ] = {v:0.3f}")
