// Native mask codec: paste-and-RLE-encode, the eval host-side hot loop.
//
// Counterpart of the reference's native mask handling (pycocotools C
// maskApi rleEncode/rleToString behind detectron2's evaluators, plus the
// chunked GPU paste_masks_in_image at detectron2/layers/mask_ops.py:74).
// Per detection this fuses: bilinear resize of the (m x m) mask probability
// crop onto its box -> 0.5 threshold -> column-major RLE -> LEB128 string,
// without ever materializing the (H, W) canvas.
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py lazy builder).
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// LEB128-style signed varint of pycocotools rleToString, with the
// delta-encoding of counts[i] -= counts[i-2] for i > 2.
// Returns bytes written, or -1 if out_cap too small.
int64_t rle_counts_to_string(const int64_t* cnts, int64_t m,
                             char* out, int64_t out_cap) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; i++) {
    long long x = cnts[i];
    if (i > 2) x -= cnts[i - 2];
    bool more = true;
    while (more) {
      char c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      c += 48;
      if (p >= out_cap) return -1;
      out[p++] = c;
    }
  }
  return p;
}

// Inverse of the above. Returns number of counts, or -1 on overflow.
int64_t rle_string_to_counts(const char* s, int64_t n,
                             int64_t* out, int64_t out_cap) {
  int64_t m = 0, p = 0;
  while (p < n) {
    long long x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (p >= n) return -1;
      char c = s[p] - 48;
      x |= (long long)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= (-1LL) << (5 * k);
    }
    if (m > 2) x += out[m - 2];
    if (m >= out_cap) return -1;
    out[m++] = (int64_t)x;
  }
  return m;
}

// Paste one (mh x mw) probability crop onto box (x1,y1,x2,y2) of an (H,W)
// canvas and emit column-major (Fortran) RLE counts directly. Mapping
// matches detectron2's _do_paste_mask (mask_ops.py) and the numpy
// evaluator path exactly: grid-sample with align_corners=False over the
// box's SUB-PIXEL extent, zero padding outside the crop, then >= thresh
// (an integer-extent resize loses the fractional box offset and shifts
// mask AP; pinned by tests/parity/test_mask_paste_parity.py).
// Returns number of counts, or -1 if out_cap too small.
int64_t paste_mask_rle(const float* prob, int64_t mh, int64_t mw,
                       const float* box, int64_t H, int64_t W,
                       float thresh, int64_t* out_counts, int64_t out_cap) {
  const float x1 = box[0], y1 = box[1], x2 = box[2], y2 = box[3];
  // integer canvas extent that the box can touch (floor/ceil then clip)
  int64_t cx0 = std::max<int64_t>(0, (int64_t)std::floor(x1));
  int64_t cx1 = std::min<int64_t>(W, (int64_t)std::ceil(x2));
  int64_t cy0 = std::max<int64_t>(0, (int64_t)std::floor(y1));
  int64_t cy1 = std::min<int64_t>(H, (int64_t)std::ceil(y2));
  const float sw = (float)(cx1 - cx0);
  const float sh = (float)(cy1 - cy0);

  int64_t m = 0;
  int64_t run = 0;   // current run length
  int cur = 0;       // current value (counts start with zeros)
  auto push = [&](int v, int64_t len) -> bool {
    if (len == 0) return true;
    if (v == cur) { run += len; return true; }
    if (m >= out_cap) return false;
    out_counts[m++] = run;
    run = len;
    cur = v;
    return true;
  };

  if (cx0 >= cx1 || cy0 >= cy1) {
    if (out_cap < 1) return -1;
    out_counts[0] = (int64_t)H * W;  // all zeros
    return 1;
  }

  const double bw = std::max((double)x2 - x1, 1e-6);
  const double bh = std::max((double)y2 - y1, 1e-6);
  (void)sw; (void)sh;
  // zero-padded fetch: positions outside the crop contribute 0
  auto at = [&](int64_t iy, int64_t ix) -> double {
    if (iy < 0 || iy >= mh || ix < 0 || ix >= mw) return 0.0;
    return (double)prob[iy * mw + ix];
  };
  // leading all-zero columns
  if (!push(0, (int64_t)cx0 * H)) return -1;
  std::vector<double> ly_v(cy1 - cy0);
  std::vector<int64_t> yi(cy1 - cy0);
  for (int64_t y = cy0; y < cy1; y++) {
    double fy = ((double)y + 0.5 - y1) / bh * (double)mh - 0.5;
    double f0 = std::floor(fy);
    ly_v[y - cy0] = fy - f0;
    yi[y - cy0] = (int64_t)f0;
  }
  for (int64_t x = cx0; x < cx1; x++) {
    double fx = ((double)x + 0.5 - x1) / bw * (double)mw - 0.5;
    double fx0 = std::floor(fx);
    int64_t ix = (int64_t)fx0;
    double lx = fx - fx0;
    // rows above the box are zero
    if (!push(0, cy0)) return -1;
    for (int64_t r = 0; r < cy1 - cy0; r++) {
      int64_t iy = yi[r];
      double ly = ly_v[r];
      double v = at(iy, ix) * (1 - ly) * (1 - lx) + at(iy, ix + 1) * (1 - ly) * lx +
                 at(iy + 1, ix) * ly * (1 - lx) + at(iy + 1, ix + 1) * ly * lx;
      if (!push(v >= thresh ? 1 : 0, 1)) return -1;
    }
    if (!push(0, H - cy1)) return -1;
  }
  // trailing all-zero columns
  if (!push(0, (int64_t)(W - cx1) * H)) return -1;
  if (m >= out_cap) return -1;
  out_counts[m++] = run;  // flush final run
  return m;
}

}  // extern "C"
