// The port's host library: four C++ functions that the host code calls in
// place of its numpy versions (echr_tpu_torch/native/__init__.py builds it
// with g++ at first use and binds it with ctypes; every call releases the
// GIL).  Each has the reference's semantics, held equal to the numpy
// version by tests/test_torch_native.py:
//
//   * iou_grid        the dense anchor/GT IoU label grid of data/labels.py
//                     (reference: dataloader.py:350-357): the +-0.01 GT
//                     nudges, and the `>=` running max, so the last GT that
//                     reaches the max wins;
//   * nms_temporal    greedy temporal NMS over the anchor grid of
//                     engine/proposals.py (reference: eval_utils.py:290-331)
//                     with the +pad area padding (1 for the grid);
//   * nms_external    NMS of external proposals, the best sentence score of
//                     each overlap cluster (reference: eval_utils.py:230-256)
//                     with +1e-3 area padding;
//   * render_captions token ids -> space-joined sentences of utils/text.py
//                     (reference: misc/utils.py:24-38): a row stops at its
//                     first id <= 0, ids past the vocab render as nothing.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// gt: [n_gt, 2] int64 featstamps.  iou_out, gts_out, mask_out: [T, K] f32.
// Anchor (t-k-1, t] is valid iff k < min(K, t).
void iou_grid(const int64_t* gt, int n_gt, int T, int K,
              float* iou_out, float* gts_out, float* mask_out) {
  std::vector<double> gs(n_gt), ge(n_gt), glen(n_gt);
  for (int g = 0; g < n_gt; ++g) {
    gs[g] = static_cast<double>(gt[2 * g]) - 0.01;
    ge[g] = static_cast<double>(gt[2 * g + 1]) + 0.01;
    glen[g] = ge[g] - gs[g];
  }
  for (int t = 0; t < T; ++t) {
    const int kmax = std::min(K, t);
    float* iou_row = iou_out + static_cast<size_t>(t) * K;
    float* gts_row = gts_out + static_cast<size_t>(t) * K;
    float* msk_row = mask_out + static_cast<size_t>(t) * K;
    for (int k = 0; k < K; ++k) {
      iou_row[k] = 0.f;
      gts_row[k] = 0.f;
      msk_row[k] = k < kmax ? 1.f : 0.f;
    }
    const double end = static_cast<double>(t);
    for (int k = 0; k < kmax; ++k) {
      const double start = static_cast<double>(t - k - 1);
      const double alen = end - start;
      double best = 0.0;
      int best_g = -1;
      for (int g = 0; g < n_gt; ++g) {
        const double inter = std::max(0.0, std::min(ge[g], end) - std::max(gs[g], start));
        const double uni = std::min(std::max(ge[g], end) - std::min(gs[g], start),
                                    glen[g] + alen);
        const double ov = inter / (uni + 1e-8);
        if (ov >= best) {  // the last GT that reaches the max wins
          best = ov;
          best_g = g;
        }
      }
      iou_row[k] = static_cast<float>(best);
      gts_row[k] = static_cast<float>(best_g < 0 ? 0 : best_g);
    }
  }
}

// props: [n, 2] int64 [start, end); scores: [n] f64.  Picks in order of
// descending score (the stable ascending order read from its end), drops
// every live proposal whose overlap with the pick exceeds `overlap`, and
// stops at topN picks.  pick_out holds topN ints; returns the picks made.
int nms_temporal(const int64_t* props, const double* scores, int n,
                 double overlap, int topN, double pad, int* pick_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] < scores[b]; });
  std::vector<char> alive(n, 1);
  int n_pick = 0;
  int top = n - 1;
  while (n_pick < topN) {
    while (top >= 0 && !alive[order[top]]) --top;
    if (top < 0) break;
    const int i = order[top];
    alive[i] = 0;
    --top;
    pick_out[n_pick++] = i;
    const double t1i = static_cast<double>(props[2 * i]);
    const double t2i = static_cast<double>(props[2 * i + 1]);
    const double area_i = t2i - t1i + pad;
    for (int jo = 0; jo <= top; ++jo) {
      const int j = order[jo];
      if (!alive[j]) continue;
      const double s = static_cast<double>(props[2 * j]);
      const double e = static_cast<double>(props[2 * j + 1]);
      const double wh = std::max(0.0, std::min(t2i, e) - std::max(t1i, s) + pad);
      const double o = wh / (area_i + (e - s + pad) - wh);
      if (o > overlap) alive[j] = 0;
    }
  }
  return n_pick;
}

// props: [n, 2] f64 seconds.  From the live proposals overlapping the one of
// the highest proposal score by >= `overlap` (itself included), picks the
// one of the best sentence score (the first in ascending proposal-score
// order on a tie), then drops the top one and every proposal overlapping it
// by more than `overlap`.  Returns the picks made, at most topN.
int nms_external(const double* props, const double* prop_scores,
                 const double* sent_scores, int n, double overlap, int topN,
                 int* pick_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return prop_scores[a] < prop_scores[b]; });
  std::vector<char> alive(n, 1);
  const double pad = 1e-3;
  int n_pick = 0;
  int top = n - 1;
  while (n_pick < topN) {
    while (top >= 0 && !alive[order[top]]) --top;
    if (top < 0) break;
    const int i = order[top];
    const double t1i = props[2 * i], t2i = props[2 * i + 1];
    const double area_i = t2i - t1i + pad;
    int best_j = -1;
    double best_s = -1e300;
    for (int jo = 0; jo <= top; ++jo) {
      const int j = order[jo];
      if (!alive[j]) continue;
      const double s = props[2 * j], e = props[2 * j + 1];
      const double wh = std::max(0.0, std::min(t2i, e) - std::max(t1i, s) + pad);
      const double o = wh / (area_i + (e - s + pad) - wh);
      if (o >= overlap && sent_scores[j] > best_s) {
        best_s = sent_scores[j];
        best_j = j;
      }
      if (o > overlap) alive[j] = 0;
    }
    alive[i] = 0;
    if (best_j >= 0) pick_out[n_pick++] = best_j;
  }
  return n_pick;
}

// words: the vocab's UTF-8 words packed end to end; offsets: [V + 1] int32,
// word i is words[offsets[i] : offsets[i + 1]].  seq: [N, L] int32.
// Sentence i is written to out[out_off[i] : out_off[i + 1]] (out_off:
// [N + 1] int64).  Returns the bytes written, or -1 if `cap` is too small.
int64_t render_captions(const char* words, const int32_t* offsets, int V,
                        const int32_t* seq, int N, int L,
                        char* out, int64_t cap, int64_t* out_off) {
  int64_t w = 0;
  for (int i = 0; i < N; ++i) {
    out_off[i] = w;
    const int32_t* row = seq + static_cast<int64_t>(i) * L;
    bool first = true;
    for (int t = 0; t < L; ++t) {
      const int32_t ix = row[t];
      if (ix <= 0) break;     // END, or a negative id, stops the row
      if (ix >= V) continue;  // past the vocab: nothing, no separator
      const int32_t a = offsets[ix], b = offsets[ix + 1];
      if (w + (b - a) + 1 > cap) return -1;
      if (!first) out[w++] = ' ';
      std::copy(words + a, words + b, out + w);
      w += b - a;
      first = false;
    }
  }
  out_off[N] = w;
  return w;
}

}  // extern "C"
