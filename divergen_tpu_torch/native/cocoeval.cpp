// Native evaluation kernels (C ABI, loaded via ctypes).
//
// TPU-native answer to the reference's vendored COCOeval C++ module
// (BSGAL/third_party/CenterNet2/detectron2/layers/csrc/cocoeval/cocoeval.cpp,
// bound as detectron2._C and used by fast_eval_api.py:88,109). Same role —
// take the per-(image,category) greedy matching and the RLE mask-IoU out of
// Python — with a plain extern "C" surface instead of a torch extension.
//
// Build: g++ -O3 -shared -fPIC cocoeval.cpp -o libcocoeval.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Greedy COCO matching for one (image, category, area-range) cell.
//   ious:      D x G row-major IoU matrix
//   g_ignore:  G   gt ignore flags (sorted: real gts first)
//   iscrowd:   G   crowd flags
//   thrs:      T   IoU thresholds
// Outputs:
//   dt_matched: T x D (0 = unmatched, else gt index + 1)
//   dt_ignore:  T x D
void greedy_match(const double* ious, int64_t D, int64_t G,
                  const uint8_t* g_ignore, const uint8_t* iscrowd,
                  const double* thrs, int64_t T,
                  int64_t* dt_matched, uint8_t* dt_ignore) {
  std::vector<uint8_t> gt_used(G);
  for (int64_t t = 0; t < T; ++t) {
    std::fill(gt_used.begin(), gt_used.end(), 0);
    for (int64_t d = 0; d < D; ++d) {
      int64_t best = -1;
      double best_iou = std::min(thrs[t], 1.0 - 1e-10);
      for (int64_t g = 0; g < G; ++g) {
        if (gt_used[g] && !iscrowd[g]) continue;
        // once matched to a real gt, never downgrade to an ignored one
        if (best > -1 && !g_ignore[best] && g_ignore[g]) break;
        double v = ious[d * G + g];
        if (v >= best_iou) { best_iou = v; best = g; }
      }
      if (best > -1) {
        dt_matched[t * D + d] = best + 1;
        dt_ignore[t * D + d] = g_ignore[best];
        gt_used[best] = 1;
      } else {
        dt_matched[t * D + d] = 0;
        dt_ignore[t * D + d] = 0;
      }
    }
  }
}

// IoU between two uncompressed RLEs (alternating 0/1 run lengths starting
// with a 0-run), without decoding. Returns intersection pixel count.
static uint64_t rle_intersection(const uint32_t* a, int64_t na,
                                 const uint32_t* b, int64_t nb) {
  if (na == 0 || nb == 0) return 0;
  uint64_t inter = 0;
  int64_t ia = 0, ib = 0;
  uint64_t pa = 0, pb = 0;      // absolute end position of current run
  uint64_t ca = a[0], cb = b[0]; // current run end positions
  bool va = false, vb = false;   // current run value
  pa = ca; pb = cb;
  uint64_t pos = 0;
  while (ia < na && ib < nb) {
    uint64_t nxt = std::min(pa, pb);
    if (va && vb) inter += nxt - pos;
    pos = nxt;
    if (pa == nxt) { ++ia; if (ia < na) { va = !va; pa += a[ia]; } }
    if (pb == nxt) { ++ib; if (ib < nb) { vb = !vb; pb += b[ib]; } }
  }
  return inter;
}

static uint64_t rle_area_(const uint32_t* r, int64_t n) {
  uint64_t s = 0;
  for (int64_t i = 1; i < n; i += 2) s += r[i];
  return s;
}

// Pairwise IoU of D det RLEs vs G gt RLEs (flattened run arrays + offsets).
//   offsets have length D+1 / G+1 (prefix offsets into the flat run arrays)
void rle_iou(const uint32_t* d_runs, const int64_t* d_off, int64_t D,
             const uint32_t* g_runs, const int64_t* g_off, int64_t G,
             const uint8_t* iscrowd, double* out) {
  std::vector<uint64_t> d_area(D), g_area(G);
  for (int64_t i = 0; i < D; ++i)
    d_area[i] = rle_area_(d_runs + d_off[i], d_off[i + 1] - d_off[i]);
  for (int64_t j = 0; j < G; ++j)
    g_area[j] = rle_area_(g_runs + g_off[j], g_off[j + 1] - g_off[j]);
  for (int64_t i = 0; i < D; ++i) {
    for (int64_t j = 0; j < G; ++j) {
      uint64_t inter = rle_intersection(d_runs + d_off[i], d_off[i + 1] - d_off[i],
                                        g_runs + g_off[j], g_off[j + 1] - g_off[j]);
      double uni = iscrowd[j] ? (double)d_area[i]
                              : (double)(d_area[i] + g_area[j] - inter);
      out[i * G + j] = uni > 0 ? (double)inter / uni : 0.0;
    }
  }
}

// Compressed-RLE (pycocotools LEB128 string) → run-length counts.
// Returns number of runs written (caller provides a big-enough buffer:
// strlen is an upper bound).
int64_t rle_from_string(const char* s, int64_t len, uint32_t* out) {
  int64_t n = 0, i = 0;
  long long last2 = 0, last1 = 0;
  while (i < len) {
    long long x = 0;
    int k = 0; bool more = true;
    while (more && i < len) {
      int c = s[i] - 48;
      x |= (long long)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i; ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (n > 2) x += last2;
    last2 = last1; last1 = x;
    out[n++] = (uint32_t)x;
  }
  return n;
}

}  // extern "C"
