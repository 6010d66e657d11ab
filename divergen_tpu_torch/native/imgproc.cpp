// Copies of the OpenCV image routines that the data augmentations and
// filtration's crops call, without OpenCV.
//
// The JAX package calls them through cv2 (divergen_tpu/data/color_jitter.py,
// instaboost.py, inp_rotate.py, poisson_blend.py and
// pipeline/filteration/cli.py:lvis_crop). Each is written after OpenCV's own
// arithmetic, so the pixels agree bit for bit with the cv2 build the tests
// hold them against unless a comment says otherwise:
//   box_blur_u8 / box_blur_f32   cv2.blur: BORDER_REFLECT_101, anchor at
//                                ksize / 2; uint8 rounds sum / area half up
//   dilate_u8                    cv2.dilate with a rectangular kernel and
//                                `iterations` (one kernel of (k - 1) n + 1),
//                                pixels outside the image ignored
//   rgb_to_hsv_u8 / hsv_to_rgb_u8  cv2.cvtColor COLOR_RGB2HSV / HSV2RGB, H in
//                                0..179 (integer division tables one way,
//                                float32 sectors the other)
//   warp_affine_u8               cv2.warpAffine, INTER_LINEAR or INTER_NEAREST,
//                                constant-0 border: OpenCV 5's kernels, float32
//                                coordinates and weights (not OpenCV 4's
//                                5-bit fixed-point weights)
//   resize_linear_f32            cv2.resize INTER_LINEAR on float32
//   inpaint_telea                cv2.inpaint INPAINT_TELEA (photo/inpaint.cpp:
//                                the same fast-marching order, ties first in,
//                                first out, and the same weights; the image
//                                gradient's border-clamped rows and columns)
//
// Build: with the other sources of divergen_tpu_torch/native (-ffp-contract=off:
// float expressions are evaluated as written, as OpenCV's scalar code is).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// OpenCV's borderInterpolate for BORDER_REFLECT_101
inline int reflect101(int p, int len) {
  if ((unsigned)p < (unsigned)len) return p;
  if (len == 1) return 0;
  do {
    p = p < 0 ? -p : len - 1 - (p - len) - 1;
  } while ((unsigned)p >= (unsigned)len);
  return p;
}

inline uint8_t sat_u8(float v) {  // saturate_cast<uchar>(float): round half to even
  int r = (int)std::nearbyint(v);
  return (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
}

inline uint8_t trunc_u8(float v) {  // OpenCV 5's HSV2RGB_b stores by truncation
  int r = (int)v;
  return (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
}

template <typename T, typename S>
void box_sums(const T* src, int64_t h, int64_t w, int64_t c, int64_t kh, int64_t kw,
              std::vector<S>& out) {
  const int64_t ay = kh / 2, ax = kw / 2;
  std::vector<S> rows((size_t)(h * w * c));
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x)
      for (int64_t ch = 0; ch < c; ++ch) {
        S s = 0;
        for (int64_t k = 0; k < kw; ++k)
          s += (S)src[(y * w + reflect101((int)(x + k - ax), (int)w)) * c + ch];
        rows[(size_t)((y * w + x) * c + ch)] = s;
      }
  out.assign((size_t)(h * w * c), 0);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t k = 0; k < kh; ++k) {
      const S* r = &rows[(size_t)(reflect101((int)(y + k - ay), (int)h) * w * c)];
      S* o = &out[(size_t)(y * w * c)];
      for (int64_t i = 0; i < w * c; ++i) o[i] += r[i];
    }
}

struct HeapItem {
  float t;
  int64_t seq;
  int i, j;
  bool operator<(const HeapItem& o) const {  // std::priority_queue is a max-heap
    return t != o.t ? t > o.t : seq > o.seq;
  }
};

// CvPriorityQueueFloat: pops the least T, equal T in the order pushed
struct FmmQueue {
  std::priority_queue<HeapItem> q;
  int64_t seq = 0;
  void push(int i, int j, float t) { q.push({t, seq++, i, j}); }
  bool pop(int& i, int& j) {
    if (q.empty()) return false;
    i = q.top().i;
    j = q.top().j;
    q.pop();
    return true;
  }
};

enum : uint8_t { KNOWN = 0, BAND = 1, INSIDE = 2, CHANGE = 3 };

float fm_solve(int i1, int j1, int i2, int j2, const std::vector<uint8_t>& f,
               const std::vector<float>& t, int cols) {
  double a11 = t[(size_t)i1 * cols + j1], a22 = t[(size_t)i2 * cols + j2];
  double m12 = std::min(a11, a22), sol;
  bool in1 = f[(size_t)i1 * cols + j1] == INSIDE, in2 = f[(size_t)i2 * cols + j2] == INSIDE;
  if (!in1) {
    if (!in2) {
      if (std::fabs(a11 - a22) >= 1.0)
        sol = 1 + m12;
      else
        sol = (a11 + a22 + std::sqrt((double)(2 - (a11 - a22) * (a11 - a22)))) * 0.5;
    } else {
      sol = 1 + a11;
    }
  } else if (!in2) {
    sol = 1 + a22;
  } else {
    sol = 1 + m12;
  }
  return (float)sol;
}

float fm_dist(int i, int j, const std::vector<uint8_t>& f, const std::vector<float>& t,
              int cols) {
  float a = fm_solve(i - 1, j, i, j - 1, f, t, cols), b = fm_solve(i + 1, j, i, j - 1, f, t, cols),
        c = fm_solve(i - 1, j, i, j + 1, f, t, cols), d = fm_solve(i + 1, j, i, j + 1, f, t, cols);
  return std::min(std::min(a, b), std::min(c, d));
}

// icvCalcFMM with negate: distances outward from the band, stored negative
void calc_fmm_outside(std::vector<uint8_t>& f, std::vector<float>& t, int rows, int cols,
                      FmmQueue& heap) {
  int ii, jj;
  while (heap.pop(ii, jj)) {
    f[(size_t)ii * cols + jj] = CHANGE;
    for (int q = 0; q < 4; ++q) {
      int i = ii + (q == 0 ? -1 : q == 2 ? 1 : 0), j = jj + (q == 1 ? -1 : q == 3 ? 1 : 0);
      if (i <= 0 || j <= 0 || i > rows || j > cols) continue;
      if (f[(size_t)i * cols + j] == INSIDE) {
        float dist = fm_dist(i, j, f, t, cols);
        t[(size_t)i * cols + j] = dist;
        f[(size_t)i * cols + j] = BAND;
        heap.push(i, j, dist);
      }
    }
  }
  for (size_t k = 0; k < f.size(); ++k)
    if (f[k] == CHANGE) {
      f[k] = KNOWN;
      t[k] = -t[k];
    }
}

// dilation of an (rows, cols) 0/nonzero map by a (2r+1)^2 square (r = 1 and
// cross shape when `cross`), values set to `value`
std::vector<uint8_t> dilate_map(const std::vector<uint8_t>& m, int rows, int cols, int r,
                                bool cross, uint8_t value) {
  std::vector<uint8_t> out((size_t)rows * cols, 0);
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j) {
      bool on = false;
      for (int di = -r; di <= r && !on; ++di)
        for (int dj = -r; dj <= r && !on; ++dj) {
          if (cross && di && dj) continue;
          int a = i + di, b = j + dj;
          if (a < 0 || b < 0 || a >= rows || b >= cols) continue;
          on = m[(size_t)a * cols + b] != 0;
        }
      if (on) out[(size_t)i * cols + j] = value;
    }
  return out;
}

}  // namespace

extern "C" {

void box_blur_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, int64_t kh, int64_t kw,
                 uint8_t* dst) {
  std::vector<int64_t> s;
  box_sums<uint8_t, int64_t>(src, h, w, c, kh, kw, s);
  const int64_t area = kh * kw;
  for (size_t i = 0; i < s.size(); ++i) {
    int64_t v = (2 * s[i] + area) / (2 * area);  // floor(s / area + 1/2)
    dst[i] = (uint8_t)(v > 255 ? 255 : v);
  }
}

void box_blur_f32(const float* src, int64_t h, int64_t w, int64_t c, int64_t kh, int64_t kw,
                  float* dst) {
  std::vector<double> s;
  box_sums<float, double>(src, h, w, c, kh, kw, s);
  const double scale = 1.0 / (double)(kh * kw);
  for (size_t i = 0; i < s.size(); ++i) dst[i] = (float)(s[i] * scale);
}

// one channel, nonzero kernel everywhere; anchor at the kernel's centre
void dilate_u8(const uint8_t* src, int64_t h, int64_t w, int64_t kh, int64_t kw,
               int64_t iterations, uint8_t* dst) {
  if (iterations < 1) {
    std::memcpy(dst, src, (size_t)(h * w));
    return;
  }
  const int64_t eh = kh + (iterations - 1) * (kh - 1), ew = kw + (iterations - 1) * (kw - 1);
  const int64_t ay = (kh / 2) * iterations, ax = (kw / 2) * iterations;
  std::vector<uint8_t> rows((size_t)(h * w));
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      uint8_t m = 0;
      for (int64_t k = std::max<int64_t>(0, x - ax); k < std::min<int64_t>(w, x - ax + ew); ++k)
        m = std::max(m, src[y * w + k]);
      rows[(size_t)(y * w + x)] = m;
    }
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      uint8_t m = 0;
      for (int64_t k = std::max<int64_t>(0, y - ay); k < std::min<int64_t>(h, y - ay + eh); ++k)
        m = std::max(m, rows[(size_t)(k * w + x)]);
      dst[y * w + x] = m;
    }
}

void rgb_to_hsv_u8(const uint8_t* src, int64_t n, uint8_t* dst) {
  const int shift = 12;  // hsv_shift
  static int sdiv[256], hdiv[256];
  static bool init = false;
  if (!init) {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = (int)std::nearbyint((255 << shift) / (1. * i));
      hdiv[i] = (int)std::nearbyint((180 << shift) / (6. * i));
    }
    init = true;
  }
  for (int64_t p = 0; p < n; ++p) {
    int r = src[3 * p], g = src[3 * p + 1], b = src[3 * p + 2];
    int v = std::max(b, std::max(g, r)), vmin = std::min(b, std::min(g, r));
    int diff = v - vmin;
    int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
    int s = (diff * sdiv[v] + (1 << (shift - 1))) >> shift;
    int hh = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + ((~vg) & (r - g + 4 * diff))));
    hh = (hh * hdiv[diff] + (1 << (shift - 1))) >> shift;
    hh += hh < 0 ? 180 : 0;
    dst[3 * p] = (uint8_t)std::min(std::max(hh, 0), 255);
    dst[3 * p + 1] = (uint8_t)s;
    dst[3 * p + 2] = (uint8_t)v;
  }
}

void hsv_to_rgb_u8(const uint8_t* src, int64_t n, uint8_t* dst) {
  const float hscale = 6.f / 180;
  for (int64_t p = 0; p < n; ++p) {
    float h = src[3 * p], s = src[3 * p + 1] * (1.f / 255.f), v = src[3 * p + 2] * (1.f / 255.f);
    h = h * hscale;
    float pre = std::trunc(h);
    h = h - pre;
    float sector = pre - std::trunc(pre * (1.0f / 6.0f)) * 6.0f;
    // OpenCV's vector code forms 1 - s h and 1 - s (1 - h) with one fused multiply-add
    float tab0 = v, tab1 = v * (1.0f - s), tab2 = v * std::fma(-s, h, 1.0f),
          tab3 = v * std::fma(-s, 1.0f - h, 1.0f);
    static const int kSector[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                      {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    const float tab[4] = {tab0, tab1, tab2, tab3};
    int sct = (int)sector;
    if (sct < 0 || sct > 5) sct = 0;
    float b = tab[kSector[sct][0]], g = tab[kSector[sct][1]], r = tab[kSector[sct][2]];
    dst[3 * p] = trunc_u8(r * 255.f);
    dst[3 * p + 1] = trunc_u8(g * 255.f);
    dst[3 * p + 2] = trunc_u8(b * 255.f);
  }
}

// m: the forward 2x3 matrix as given to cv2.warpAffine (src -> dst)
void warp_affine_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const double* m,
                    int64_t dh, int64_t dw, int64_t nearest, uint8_t* dst) {
  double M[6] = {m[0], m[1], m[2], m[3], m[4], m[5]};
  {  // invertAffineTransform, as warpAffine does without WARP_INVERSE_MAP
    double D = M[0] * M[4] - M[1] * M[3];
    D = D != 0 ? 1. / D : 0;
    double A11 = M[4] * D, A22 = M[0] * D;
    M[0] = A11;
    M[1] *= -D;
    M[3] *= -D;
    M[4] = A22;
    double b1 = -M[0] * M[2] - M[1] * M[5];
    double b2 = -M[3] * M[2] - M[4] * M[5];
    M[2] = b1;
    M[5] = b2;
  }
  const float F[6] = {(float)M[0], (float)M[1], (float)M[2], (float)M[3], (float)M[4], (float)M[5]};
  // OpenCV 5's warp kernels map a row's pixels in vectors of kLanes with
  // x M0 + (y M1 + M2) fused; the scalar tail, as its compiler contracts it,
  // computes fma(x, M0, y M1) + M2. kLanes is the float width of the build's
  // widest dispatched instruction set (AVX-512 here).
  const int64_t kLanes = 16, vec_end = dw - dw % kLanes;
  for (int64_t y = 0; y < dh; ++y) {
    const float fy = (float)y, mx = fy * F[1] + F[2], my = fy * F[4] + F[5];
    for (int64_t x = 0; x < dw; ++x) {
      const float fx = (float)x;
      float sx, sy;
      if (x < vec_end) {
        sx = std::fma(F[0], fx, mx);
        sy = std::fma(F[3], fx, my);
      } else {
        sx = std::fma(fx, F[0], fy * F[1]) + F[2];
        sy = std::fma(fx, F[3], fy * F[4]) + F[5];
      }
      uint8_t* o = dst + (y * dw + x) * c;
      if (nearest) {
        int ix = (int)std::nearbyint(sx), iy = (int)std::nearbyint(sy);
        if (ix >= 0 && ix < w && iy >= 0 && iy < h)
          std::memcpy(o, src + ((int64_t)iy * w + ix) * c, (size_t)c);
        else
          std::memset(o, 0, (size_t)c);
        continue;
      }
      int ix = (int)std::floor(sx), iy = (int)std::floor(sy);
      float ax = sx - (float)ix, ay = sy - (float)iy;
      for (int64_t ch = 0; ch < c; ++ch) {
        auto px = [&](int yy, int xx) -> float {  // constant 0 outside the image
          if (xx < 0 || yy < 0 || xx >= w || yy >= h) return 0.f;
          return (float)src[((int64_t)yy * w + xx) * c + ch];
        };
        float p00 = px(iy, ix), p01 = px(iy, ix + 1), p10 = px(iy + 1, ix),
              p11 = px(iy + 1, ix + 1);
        float f0 = std::fma(ax, p01 - p00, p00), f1 = std::fma(ax, p11 - p10, p10);
        o[ch] = sat_u8(std::fma(ay, f1 - f0, f0));
      }
    }
  }
}

void resize_linear_f32(const float* src, int64_t h, int64_t w, int64_t c, int64_t dh,
                       int64_t dw, float* dst) {
  auto coeffs = [](int64_t n_in, int64_t n_out, std::vector<int>& ofs, std::vector<float>& a) {
    double scale = 1. / ((double)n_out / n_in);
    ofs.resize((size_t)n_out);
    a.resize((size_t)n_out);
    for (int64_t d = 0; d < n_out; ++d) {
      float f = (float)((d + 0.5) * scale - 0.5);
      int s = (int)std::floor(f);
      f -= (float)s;
      if (s < 0) f = 0, s = 0;
      if (s >= n_in - 1) f = 0, s = (int)n_in - 1;
      ofs[(size_t)d] = s;
      a[(size_t)d] = f;
    }
  };
  std::vector<int> xo, yo;
  std::vector<float> xa, ya;
  coeffs(w, dw, xo, xa);
  coeffs(h, dh, yo, ya);
  std::vector<float> rows((size_t)(h * dw * c));
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < dw; ++x) {
      int s = xo[(size_t)x];
      float a1 = xa[(size_t)x], a0 = 1.f - a1;
      int s1 = s + 1 < w ? s + 1 : s;
      for (int64_t ch = 0; ch < c; ++ch)
        rows[(size_t)((y * dw + x) * c + ch)] =
            src[(y * w + s) * c + ch] * a0 + src[(y * w + s1) * c + ch] * a1;
    }
  for (int64_t y = 0; y < dh; ++y) {
    int s = yo[(size_t)y];
    float b1 = ya[(size_t)y], b0 = 1.f - b1;
    int s1 = s + 1 < h ? s + 1 : s;
    const float* r0 = &rows[(size_t)(s * dw * c)];
    const float* r1 = &rows[(size_t)(s1 * dw * c)];
    for (int64_t i = 0; i < dw * c; ++i) dst[y * dw * c + i] = r0[i] * b0 + r1[i] * b1;
  }
}

// src/dst: (h, w, c) uint8; mask: (h, w), nonzero = inpaint
void inpaint_telea_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const uint8_t* mask,
                      double radius, uint8_t* dst) {
  std::memcpy(dst, src, (size_t)(h * w * c));
  int range = (int)std::nearbyint(radius);
  range = std::max(range, 1);
  range = std::min(range, 100);
  const int rows = (int)h + 2, cols = (int)w + 2;
  const size_t N = (size_t)rows * cols;
  std::vector<uint8_t> m(N, KNOWN);
  for (int64_t i = 0; i < h; ++i)
    for (int64_t j = 0; j < w; ++j)
      if (mask[i * w + j]) m[(size_t)(i + 1) * cols + (j + 1)] = INSIDE;
  for (int i = 0; i < rows; ++i) m[(size_t)i * cols] = m[(size_t)i * cols + cols - 1] = 0;
  for (int j = 0; j < cols; ++j) m[j] = m[N - cols + j] = 0;
  std::vector<float> t(N, 1.0e6f);
  // the narrow band: the cross dilation of the mask, less the mask
  std::vector<uint8_t> band = dilate_map(m, rows, cols, 1, true, INSIDE);
  for (size_t k = 0; k < N; ++k) band[k] = m[k] ? 0 : band[k];
  for (int i = 0; i < rows; ++i) band[(size_t)i * cols] = band[(size_t)i * cols + cols - 1] = 0;
  for (int j = 0; j < cols; ++j) band[j] = band[N - cols + j] = 0;
  FmmQueue heap, out_heap;
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j)
      if (band[(size_t)i * cols + j]) {
        heap.push(i, j, 0.f);
        out_heap.push(i, j, 0.f);
        t[(size_t)i * cols + j] = 0.f;
      }
  // distances outside the mask, within `range`, marched from the band
  std::vector<uint8_t> out = dilate_map(m, rows, cols, range, false, INSIDE);
  for (size_t k = 0; k < N; ++k) out[k] = (m[k] || band[k]) ? 0 : out[k];
  for (int i = 0; i < rows; ++i) out[(size_t)i * cols] = out[(size_t)i * cols + cols - 1] = 0;
  for (int j = 0; j < cols; ++j) out[j] = out[N - cols + j] = 0;
  calc_fmm_outside(out, t, rows - 2, cols, out_heap);

  std::vector<uint8_t>& f = m;  // KNOWN / BAND / INSIDE as the march goes
  auto F = [&](int i, int j) { return f[(size_t)i * cols + j]; };
  auto T = [&](int i, int j) { return t[(size_t)i * cols + j]; };
  auto OUT = [&](int i, int j, int ch) -> float { return (float)dst[((int64_t)i * w + j) * c + ch]; };
  int ii, jj;
  while (heap.pop(ii, jj)) {
    f[(size_t)ii * cols + jj] = KNOWN;
    for (int q = 0; q < 4; ++q) {
      int i = ii + (q == 0 ? -1 : q == 2 ? 1 : 0), j = jj + (q == 1 ? -1 : q == 3 ? 1 : 0);
      if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) continue;
      if (F(i, j) != INSIDE) continue;
      float dist = fm_dist(i, j, f, t, cols);
      t[(size_t)i * cols + j] = dist;
      for (int64_t color = 0; color < c; ++color) {
        float gtx, gty;
        if (F(i, j + 1) != INSIDE)
          gtx = F(i, j - 1) != INSIDE ? (T(i, j + 1) - T(i, j - 1)) * 0.5f : T(i, j + 1) - T(i, j);
        else
          gtx = F(i, j - 1) != INSIDE ? T(i, j) - T(i, j - 1) : 0.f;
        if (F(i + 1, j) != INSIDE)
          gty = F(i - 1, j) != INSIDE ? (T(i + 1, j) - T(i - 1, j)) * 0.5f : T(i + 1, j) - T(i, j);
        else
          gty = F(i - 1, j) != INSIDE ? T(i, j) - T(i - 1, j) : 0.f;
        float Ia = 0, Jx = 0, Jy = 0, s = 1.0e-20f;
        for (int k = i - range; k <= i + range; ++k) {
          int km = k - 1 + (k == 1), kp = k - 1 - (k == rows - 2);
          for (int l = j - range; l <= j + range; ++l) {
            int lm = l - 1 + (l == 1), lp = l - 1 - (l == cols - 2);
            if (!(k > 0 && l > 0 && k < rows - 1 && l < cols - 1)) continue;
            if (F(k, l) == INSIDE || (l - j) * (l - j) + (k - i) * (k - i) > range * range)
              continue;
            float ry = (float)(i - k), rx = (float)(j - l);
            float len2 = rx * rx + ry * ry;
            float dst_w = (float)(1. / (len2 * std::sqrt((double)len2)));
            float lev = (float)(1. / (1 + std::fabs((double)T(k, l) - (double)T(i, j))));
            float dir = rx * gtx + ry * gty;
            if (std::fabs(dir) <= 0.01) dir = 0.000001f;
            float wgt = (float)std::fabs(dst_w * lev * dir);
            float gix, giy;
            if (F(k, l + 1) != INSIDE)
              gix = F(k, l - 1) != INSIDE ? (OUT(km, lp + 1, color) - OUT(km, lm - 1, color)) * 2.0f
                                          : OUT(km, lp + 1, color) - OUT(km, lm, color);
            else
              gix = F(k, l - 1) != INSIDE ? OUT(km, lp, color) - OUT(km, lm - 1, color) : 0.f;
            if (F(k + 1, l) != INSIDE)
              giy = F(k - 1, l) != INSIDE ? (OUT(kp + 1, lm, color) - OUT(km - 1, lm, color)) * 2.0f
                                          : OUT(kp + 1, lm, color) - OUT(km, lm, color);
            else
              giy = F(k - 1, l) != INSIDE ? OUT(kp, lm, color) - OUT(km - 1, lm, color) : 0.f;
            Ia += wgt * OUT(k - 1, l - 1, color);
            Jx -= wgt * (gix * rx);
            Jy -= wgt * (giy * ry);
            s += wgt;
          }
        }
        float sat = (float)(Ia / s + (Jx + Jy) / (std::sqrt(Jx * Jx + Jy * Jy) + 1.0e-20f) + 0.5f);
        dst[((int64_t)(i - 1) * w + (j - 1)) * c + color] = sat_u8(sat);
      }
      f[(size_t)i * cols + j] = BAND;
      heap.push(i, j, dist);
    }
  }
}

}  // extern "C"
