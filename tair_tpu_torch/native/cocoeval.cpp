// COCO-style average-precision accumulation over precomputed IoU matrices.
//
// The port's copy of native/cocoeval.cpp, built by tair_tpu_torch/native_ext.py.
// Native counterpart of the vendored fast cocoeval (detectron2's
// detectron2/layers/csrc/cocoeval/cocoeval.cpp): detectron2 computes IoUs in
// Python and accelerates the per-threshold score-ranked matching + PR
// accumulation in C++; this does the same for the text-spotting polygon AP
// (tair_tpu_torch/utils/text_eval.py computes polygon IoUs on rasterised masks
// and calls this for the matching/accumulation).
//
// Semantics mirror text_eval.average_precision exactly: per image, preds are
// visited in stable score-descending order, each greedily takes the
// still-free gt with the highest IoU >= threshold (ties -> last index);
// AP is 101-point interpolated precision over the global stable
// score-descending ranking.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" void coco_ap(const float* ious,       // concat [n_pred_i, n_gt_i]
                        const float* scores,     // concat [n_pred_i]
                        const int* n_pred, const int* n_gt, int n_images,
                        const float* thresholds, int n_thr,
                        double* out_ap) {        // [n_thr]
  std::vector<int64_t> iou_off(n_images + 1, 0), sc_off(n_images + 1, 0);
  int64_t total_gt = 0, total_pred = 0;
  for (int i = 0; i < n_images; ++i) {
    iou_off[i + 1] = iou_off[i] + static_cast<int64_t>(n_pred[i]) * n_gt[i];
    sc_off[i + 1] = sc_off[i] + n_pred[i];
    total_gt += n_gt[i];
    total_pred += n_pred[i];
  }

  for (int t = 0; t < n_thr; ++t) {
    if (total_gt == 0) {
      out_ap[t] = 0.0;
      continue;
    }
    const float thr = thresholds[t];
    std::vector<std::pair<float, char>> scored;  // (score, is_tp)
    scored.reserve(static_cast<size_t>(total_pred));
    for (int im = 0; im < n_images; ++im) {
      const int np = n_pred[im], ng = n_gt[im];
      const float* sc = scores + sc_off[im];
      const float* iou = ious + iou_off[im];
      std::vector<int> order(np);
      for (int i = 0; i < np; ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(),
                       [&](int a, int b) { return sc[a] > sc[b]; });
      std::vector<char> taken(ng, 0);
      for (int oi = 0; oi < np; ++oi) {
        const int i = order[oi];
        int best = -1;
        float best_iou = thr;
        for (int j = 0; j < ng; ++j) {
          if (taken[j]) continue;
          const float v = iou[static_cast<int64_t>(i) * ng + j];
          if (v >= best_iou) {
            best = j;
            best_iou = v;
          }
        }
        if (best >= 0) {
          taken[best] = 1;
          scored.emplace_back(sc[i], 1);
        } else {
          scored.emplace_back(sc[i], 0);
        }
      }
    }
    std::stable_sort(
        scored.begin(), scored.end(),
        [](const std::pair<float, char>& a, const std::pair<float, char>& b) {
          return a.first > b.first;
        });
    const int n = static_cast<int>(scored.size());
    std::vector<double> recall(n), prec(n);
    double tp = 0, fp = 0;
    for (int i = 0; i < n; ++i) {
      tp += scored[i].second;
      fp += 1 - scored[i].second;
      recall[i] = tp / static_cast<double>(total_gt);
      prec[i] = tp / std::max(tp + fp, 1e-9);
    }
    std::vector<double> pmax(n + 1, 0.0);  // max precision from i onward
    for (int i = n - 1; i >= 0; --i) pmax[i] = std::max(pmax[i + 1], prec[i]);
    double ap = 0.0;
    for (int r = 0; r <= 100; ++r) {
      const double rr = r / 100.0;
      const int lo = static_cast<int>(
          std::lower_bound(recall.begin(), recall.end(), rr) - recall.begin());
      if (lo < n) ap += pmax[lo] / 101.0;
    }
    out_ap[t] = ap;
  }
}
