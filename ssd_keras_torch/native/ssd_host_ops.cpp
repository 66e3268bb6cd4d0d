// Native host-side kernels for ssd_keras_torch.
//
// A copy of ssd_keras_tpu/native/ssd_host_ops.cpp. The card does all tensor
// compute; these C++ kernels cover the *host* hot
// loops that remain: greedy NMS over ragged decoded predictions and the
// evaluator's prediction-to-ground-truth matching (a Python loop over every
// prediction in the dataset in the reference,
// eval_utils/average_precision_evaluator.py:649-719).
//
// Numerics contract (matches ops/boxes.py): IoU computes the *intersection*
// with the 'half' convention (delta 0) regardless of border_pixels, while
// the union areas apply the border delta — the reference's iou() quirk
// (bounding_box_utils.py:345).
//
// Built at first use by native/__init__.py: g++ -O3 -shared -fPIC, into
// ssd_keras_torch/_build/, named by a hash of this source.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline float iou_corners(const float* a, const float* b, int border_delta) {
  const float d = static_cast<float>(border_delta);
  const float ix1 = a[0] > b[0] ? a[0] : b[0];
  const float iy1 = a[1] > b[1] ? a[1] : b[1];
  const float ix2 = a[2] < b[2] ? a[2] : b[2];
  const float iy2 = a[3] < b[3] ? a[3] : b[3];
  // Intersection: always the 'half' convention (reference quirk).
  const float iw = ix2 - ix1 > 0.f ? ix2 - ix1 : 0.f;
  const float ih = iy2 - iy1 > 0.f ? iy2 - iy1 : 0.f;
  const float inter = iw * ih;
  const float area_a = (a[2] - a[0] + d) * (a[3] - a[1] + d);
  const float area_b = (b[2] - b[0] + d) * (b[3] - b[1] + d);
  const float uni = area_a + area_b - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

}  // namespace

extern "C" {

// Greedy NMS over n candidate rows.
//   scores: (n,)       boxes: (n, 4) corners x1,y1,x2,y2
//   keep:   (n,) out   selection-order indices of survivors
// Returns the number of survivors. Exact greedy: repeatedly take the highest
// remaining score, drop everything with IoU > threshold against it.
int ssd_greedy_nms(const float* scores, const float* boxes, int n,
                   float iou_threshold, int border_delta, int* keep) {
  std::vector<uint8_t> alive(n, 1);
  int n_kept = 0;
  for (;;) {
    int best = -1;
    float best_score = -1.f;
    for (int i = 0; i < n; ++i) {
      if (alive[i] && scores[i] > best_score) {
        best_score = scores[i];
        best = i;
      }
    }
    if (best < 0) break;
    keep[n_kept++] = best;
    alive[best] = 0;
    const float* bb = boxes + 4 * best;
    for (int i = 0; i < n; ++i) {
      if (alive[i] &&
          iou_corners(boxes + 4 * i, bb, border_delta) > iou_threshold) {
        alive[i] = 0;
      }
    }
  }
  return n_kept;
}

// Evaluator prediction matching for one class.
//   pred_img:   (n_preds,) dense image index per prediction, sorted by
//               descending confidence (ties already resolved by the caller)
//   pred_boxes: (n_preds, 4)
//   gt_offsets: (n_images + 1,) prefix offsets into gt_boxes for this class
//   gt_boxes:   (total_gt, 4)
//   gt_neutral: (total_gt,) 0/1, or null if neutrality isn't tracked
//   tp, fp:     (n_preds,) outputs, 0/1
// Greedy best-IoU matching with duplicate-detection -> FP and neutral-GT
// skipping (neither TP nor FP), identical to the reference algorithm.
void ssd_match_predictions(const int32_t* pred_img, const float* pred_boxes,
                           int n_preds, const int32_t* gt_offsets,
                           const float* gt_boxes, const uint8_t* gt_neutral,
                           int n_images, float iou_threshold, int border_delta,
                           uint8_t* tp, uint8_t* fp) {
  const int total_gt = gt_offsets[n_images];
  std::vector<uint8_t> claimed(total_gt, 0);
  for (int p = 0; p < n_preds; ++p) {
    tp[p] = 0;
    fp[p] = 0;
    const int img = pred_img[p];
    const int begin = gt_offsets[img];
    const int end = gt_offsets[img + 1];
    if (begin == end) {
      fp[p] = 1;  // no same-class GT in this image
      continue;
    }
    const float* pb = pred_boxes + 4 * p;
    int best = -1;
    float best_iou = -1.f;
    for (int g = begin; g < end; ++g) {
      const float v = iou_corners(gt_boxes + 4 * g, pb, border_delta);
      if (v > best_iou) {
        best_iou = v;
        best = g;
      }
    }
    if (best_iou < iou_threshold) {
      fp[p] = 1;
    } else if (gt_neutral != nullptr && gt_neutral[best]) {
      // Evaluation-neutral ground truth: skip (neither TP nor FP).
    } else if (!claimed[best]) {
      tp[p] = 1;
      claimed[best] = 1;
    } else {
      fp[p] = 1;  // duplicate detection of an already-claimed GT
    }
  }
}

// Pairwise IoU matrix: boxes1 (m, 4) x boxes2 (n, 4) -> out (m, n).
void ssd_iou_matrix(const float* boxes1, int m, const float* boxes2, int n,
                    int border_delta, float* out) {
  for (int i = 0; i < m; ++i) {
    const float* a = boxes1 + 4 * i;
    float* row = out + static_cast<int64_t>(i) * n;
    for (int j = 0; j < n; ++j) {
      row[j] = iou_corners(a, boxes2 + 4 * j, border_delta);
    }
  }
}

}  // extern "C"
