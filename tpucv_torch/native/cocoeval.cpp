// Native COCO bbox evaluation core (counterpart of pycocotools' C COCOeval,
// reference core/metrics/mAP.py:10-11 usage). The Python-side numpy engine
// (tpucv_torch/metrics/coco_map.py) is the semantic reference; this file is
// the production fast path for real-dataset evaluation, where the per-image
// greedy matching is O(imgs * cats * T * D * G) and dominates eval time.
//
// Protocol (pycocotools cocoeval.py semantics, bbox only):
//   * per (img, cat): dets sorted by score desc (stable), capped at
//     maxDets[-1]; gts sorted ignored-last (stable)
//   * crowd gts match via intersection/det-area and may match many dets
//   * greedy match per IoU threshold: best IoU >= thr, prefer real gts over
//     ignored ones (stop scanning ignored once a real match is held)
//   * unmatched dets with area outside the range are ignored
//   * accumulate: per-image truncation to maxDet BEFORE the global stable
//     score sort; precision envelope; 101-point recall sampling
//
// Built on first use by tpucv_torch/_build.py:build_native (g++ -O3
// -shared -fPIC -std=c++17).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Group {            // dets+gts of one (img, cat) cell
    std::vector<int> dt;  // indices into the flat dt arrays, score-desc
    std::vector<int> gt;  // indices into the flat gt arrays
};

inline double iou_one(const double* d, const double* g, bool crowd) {
    // boxes are xywh
    const double dx1 = d[0], dy1 = d[1], dx2 = d[0] + d[2], dy2 = d[1] + d[3];
    const double gx1 = g[0], gy1 = g[1], gx2 = g[0] + g[2], gy2 = g[1] + g[3];
    const double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
    const double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
    if (iw <= 0 || ih <= 0) return 0.0;
    const double inter = iw * ih;
    const double da = d[2] * d[3], ga = g[2] * g[3];
    const double uni = crowd ? da : da + ga - inter;
    return uni > 1e-9 ? inter / uni : 0.0;
}

}  // namespace

extern "C" int cocoeval_bbox(
    // ground truths (flat)
    int n_gt, const double* gt_boxes, const uint8_t* gt_iscrowd,
    const double* gt_area, const int32_t* gt_img, const int32_t* gt_cat,
    // detections (flat)
    int n_dt, const double* dt_boxes, const double* dt_scores,
    const int32_t* dt_img, const int32_t* dt_cat,
    int n_imgs, int n_cats,  // ids densely re-indexed to 0..n-1 by caller
    // protocol parameters
    int T, const double* iou_thrs, int R, const double* rec_thrs,
    int A, const double* area_rng /* (A,2) */, int M, const int32_t* max_dets,
    // outputs, caller-zeroed to -1: precision (T,R,K,A,M), recall (T,K,A,M)
    double* precision, double* recall) {
    const int K = n_cats;
    const int max_det_cap = max_dets[M - 1];

    // ---- group det/gt indices by (img, cat)
    std::vector<Group> cells((size_t)n_imgs * K);
    for (int i = 0; i < n_gt; i++)
        cells[(size_t)gt_img[i] * K + gt_cat[i]].gt.push_back(i);
    for (int i = 0; i < n_dt; i++)
        cells[(size_t)dt_img[i] * K + dt_cat[i]].dt.push_back(i);
    for (auto& c : cells) {
        std::stable_sort(c.dt.begin(), c.dt.end(), [&](int a, int b) {
            return dt_scores[a] > dt_scores[b];
        });
        if ((int)c.dt.size() > max_det_cap) c.dt.resize(max_det_cap);
    }

    // ---- per-image evaluation state, reused across (cat, area) cells
    // dt_m / dt_ig are (T, D) row-major for the current cell
    std::vector<int> g_order;
    std::vector<uint8_t> g_ignore;
    std::vector<double> ious;  // (D, G)

    // accumulate buffers per (cat, area, maxdet)
    struct ImgEval {             // one evaluated (img) cell for a fixed area
        std::vector<int> dtm;    // (T, D): matched gt slot or -1
        std::vector<uint8_t> dtig;  // (T, D)
        std::vector<double> scores;  // (D)
        int n_dt = 0, n_gt = 0;
    };

    std::vector<double> pr, rc;  // scratch
    for (int k = 0; k < K; k++) {
        for (int a = 0; a < A; a++) {
            const double lo = area_rng[2 * a], hi = area_rng[2 * a + 1];
            std::vector<ImgEval> evals;
            evals.reserve(n_imgs);
            long total_dt = 0;
            for (int im = 0; im < n_imgs; im++) {
                const Group& c = cells[(size_t)im * K + k];
                const int D = (int)c.dt.size(), G = (int)c.gt.size();
                if (D == 0 && G == 0) continue;
                // gt ignore flags for this area range (inclusive bounds:
                // area < lo or area > hi => ignored), ignored sorted last
                g_order.resize(G);
                g_ignore.resize(G);
                for (int gi = 0; gi < G; gi++) g_order[gi] = gi;
                std::vector<uint8_t> raw_ig(G);
                for (int gi = 0; gi < G; gi++) {
                    const int g = c.gt[gi];
                    raw_ig[gi] = gt_iscrowd[g] || gt_area[g] < lo ||
                                 gt_area[g] > hi;
                }
                std::stable_sort(g_order.begin(), g_order.end(),
                                 [&](int x, int y) {
                                     return raw_ig[x] < raw_ig[y];
                                 });
                for (int gi = 0; gi < G; gi++) g_ignore[gi] = raw_ig[g_order[gi]];

                ious.assign((size_t)D * G, 0.0);
                for (int di = 0; di < D; di++) {
                    const double* db = dt_boxes + 4 * (size_t)c.dt[di];
                    for (int gi = 0; gi < G; gi++) {
                        const int g = c.gt[g_order[gi]];
                        ious[(size_t)di * G + gi] =
                            iou_one(db, gt_boxes + 4 * (size_t)g,
                                    gt_iscrowd[g]);
                    }
                }

                ImgEval ev;
                ev.n_dt = D;
                ev.dtm.assign((size_t)T * D, -1);
                ev.dtig.assign((size_t)T * D, 0);
                ev.scores.resize(D);
                for (int di = 0; di < D; di++)
                    ev.scores[di] = dt_scores[c.dt[di]];
                std::vector<int> gtm(G);
                for (int ti = 0; ti < T; ti++) {
                    const double thr = iou_thrs[ti];
                    std::fill(gtm.begin(), gtm.end(), -1);
                    for (int di = 0; di < D; di++) {
                        double best = std::min(thr, 1 - 1e-10);
                        int bestg = -1;
                        for (int gi = 0; gi < G; gi++) {
                            const int g = c.gt[g_order[gi]];
                            if (gtm[gi] >= 0 && !gt_iscrowd[g]) continue;
                            if (bestg > -1 && !g_ignore[bestg] && g_ignore[gi])
                                break;
                            const double v = ious[(size_t)di * G + gi];
                            if (v < best) continue;
                            best = v;
                            bestg = gi;
                        }
                        if (bestg == -1) continue;
                        ev.dtig[(size_t)ti * D + di] = g_ignore[bestg];
                        ev.dtm[(size_t)ti * D + di] = bestg;
                        gtm[bestg] = di;
                    }
                }
                // unmatched dets outside the area range are ignored
                for (int di = 0; di < D; di++) {
                    const double* db = dt_boxes + 4 * (size_t)c.dt[di];
                    const double da = db[2] * db[3];
                    if (da < lo || da > hi)
                        for (int ti = 0; ti < T; ti++)
                            if (ev.dtm[(size_t)ti * D + di] == -1)
                                ev.dtig[(size_t)ti * D + di] = 1;
                }
                for (int gi = 0; gi < G; gi++)
                    if (!g_ignore[gi]) ev.n_gt++;
                total_dt += D;
                evals.push_back(std::move(ev));
            }
            if (evals.empty()) continue;

            for (int m = 0; m < M; m++) {
                const int md = max_dets[m];
                long npig = 0, nd = 0;
                // per-image truncation to md BEFORE the global stable sort
                std::vector<std::pair<double, long>> keyed;  // (-score, flat)
                keyed.reserve((size_t)std::min(
                    (long)md * (long)evals.size(), total_dt));
                std::vector<long> base(evals.size());
                long off = 0;
                for (size_t e = 0; e < evals.size(); e++) {
                    base[e] = off;
                    const int take = std::min(evals[e].n_dt, md);
                    for (int di = 0; di < take; di++)
                        keyed.emplace_back(-evals[e].scores[di],
                                           off + di);
                    off += take;
                    npig += evals[e].n_gt;
                }
                nd = (long)keyed.size();
                if (npig == 0) continue;
                std::stable_sort(keyed.begin(), keyed.end(),
                                 [](const auto& x, const auto& y) {
                                     return x.first < y.first;
                                 });
                // flat index -> (eval idx, det idx) lookup
                std::vector<int> ev_of(nd ? off : 0), di_of(nd ? off : 0);
                for (size_t e = 0; e < evals.size(); e++) {
                    const int take = std::min(evals[e].n_dt, md);
                    for (int di = 0; di < take; di++) {
                        ev_of[base[e] + di] = (int)e;
                        di_of[base[e] + di] = di;
                    }
                }
                for (int ti = 0; ti < T; ti++) {
                    pr.assign(nd, 0.0);
                    rc.assign(nd, 0.0);
                    double tp = 0, fp = 0;
                    for (long j = 0; j < nd; j++) {
                        const long f = keyed[j].second;
                        const ImgEval& ev = evals[ev_of[f]];
                        const int D = ev.n_dt, di = di_of[f];
                        const bool ig = ev.dtig[(size_t)ti * D + di];
                        const bool matched =
                            ev.dtm[(size_t)ti * D + di] >= 0;
                        if (!ig) (matched ? tp : fp) += 1.0;
                        rc[j] = tp / npig;
                        pr[j] = tp / std::max(tp + fp, 1e-300);
                    }
                    double* rec_out =
                        recall + (((size_t)ti * K + k) * A + a) * M + m;
                    *rec_out = nd ? rc[nd - 1] : 0.0;
                    // monotone precision envelope
                    for (long j = nd - 1; j > 0; j--)
                        pr[j - 1] = std::max(pr[j - 1], pr[j]);
                    // sample at the 101 recall thresholds (searchsorted left)
                    for (int ri = 0; ri < R; ri++) {
                        const long pi = std::lower_bound(rc.begin(), rc.end(),
                                                         rec_thrs[ri]) -
                                        rc.begin();
                        double v = 0.0;
                        if (pi < nd) v = pr[pi];
                        precision[((((size_t)ti * R + ri) * K + k) * A + a) *
                                      M + m] = v;
                    }
                }
            }
        }
    }
    return 0;
}
