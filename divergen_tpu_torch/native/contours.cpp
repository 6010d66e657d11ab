// Outer borders of a binary mask with the points, the order and the
// approximation of OpenCV's findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE),
// without OpenCV.
//
// The JAX package keeps the largest part of a pool instance's alpha with
// cv2.findContours + cv2.contourArea + cv2.fillPoly
// (divergen_tpu/data/inst_pool.py:largest_component). "Largest 8-connected
// component by pixel count, holes filled" differs from that on thin shapes
// (a one-pixel line has contour area 0) and on ties (the first contour in
// findContours' order wins). So the border following is OpenCV's own, step
// for step: Suzuki-Abe on a copy of the mask with a one-pixel zero frame,
// values thresholded to 0 / 1; the raster scan of cvFindNextContour with
// its last-border bookkeeping (lnbd), which in EXTERNAL mode skips holes and
// every border whose nearest marked border pixel to the left is a left
// border (so components inside another's hole are never traced); the 3x3
// neighbour walk of icvFetchContour, which marks right-bound pixels -126
// and others 2 and, under CHAIN_APPROX_SIMPLE, writes a point where the
// chain code changes. Contours come out in the order cv::findContours
// returns them: each new outer border becomes the first child of the
// frame, so the last one found comes first.
//
// Build: with the other sources of divergen_tpu_torch/native.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kCodeDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kCodeDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
constexpr int kMaxSize = 16;

struct Pt {
  int64_t x, y;
};

// icvFetchContour for an outer border (s starts at 4), CHAIN_APPROX_SIMPLE.
void fetch_contour(int8_t* i0, int64_t step, Pt pt, std::vector<Pt>& out) {
  const int8_t nbd = 2;
  int64_t deltas[kMaxSize];
  const int64_t base[8] = {1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1};
  for (int k = 0; k < 8; ++k) deltas[k] = deltas[k + 8] = base[k];

  int8_t *i1, *i3, *i4 = nullptr;
  int s, s_end, prev_s;
  s_end = s = 4;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (*i1 == 0 && s != s_end);

  if (s == s_end) {  // single pixel domain
    *i0 = (int8_t)(nbd | -128);
    out.push_back(pt);
    return;
  }
  i3 = i0;
  prev_s = s ^ 4;
  for (;;) {
    s_end = s;
    if (s > kMaxSize - 1) s = kMaxSize - 1;
    while (s < kMaxSize - 1) {
      i4 = i3 + deltas[++s];
      if (*i4 != 0) break;
    }
    s &= 7;
    // the "right" bound: the pixel to the right was examined and is 0
    if ((unsigned)(s - 1) < (unsigned)s_end) {
      *i3 = (int8_t)(nbd | -128);
    } else if (*i3 == 1) {
      *i3 = nbd;
    }
    if (s != prev_s) {
      out.push_back(pt);
      prev_s = s;
    }
    pt.x += kCodeDx[s];
    pt.y += kCodeDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

// Every outer border in findContours' output order.
std::vector<std::vector<Pt>> external_borders(const uint8_t* mask, int64_t h, int64_t w) {
  const int64_t step = w + 2;
  std::vector<int8_t> img((size_t)(h + 2) * step, 0);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) img[(y + 1) * step + x + 1] = mask[y * w + x] != 0;

  std::vector<std::vector<Pt>> found;
  int8_t* img0 = img.data();
  const int64_t width = w + 1, height = h + 1;
  for (int64_t y = 1; y < height; ++y) {
    int8_t* row = img0 + y * step;
    int64_t lnbd_x = 0;  // lnbd.y is the current row
    int prev = 0;
    for (int64_t x = 1; x < width; ++x) {
      int p;
      for (; x < width && (p = row[x]) == prev; ++x) {
      }
      if (x >= width) break;
      bool skip = false;
      int is_hole = 0;
      if (!(prev == 0 && p == 1)) {  // not an outer border start
        if (p != 0 || prev < 1) {
          skip = true;
        } else {
          if (prev & -2) lnbd_x = x - 1;
          is_hole = 1;
        }
      }
      if (!skip && (is_hole || row[lnbd_x] > 0)) skip = true;
      if (!skip) {
        found.emplace_back();
        fetch_contour(row + x, step, Pt{x - 1, y - 1}, found.back());
        // the scan resumes after the start pixel, whose value the walk changed
        prev = row[x];
        continue;
      }
      prev = p;
      if (prev & -2) lnbd_x = x;
    }
  }
  return std::vector<std::vector<Pt>>(found.rbegin(), found.rend());
}

}  // namespace

extern "C" {

// The outer borders of an (h, w) uint8 mask (nonzero = set) as findContours
// (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) gives them: contour k has counts[k]
// points, stored one after the other in pts as (x, y) pairs. Writes at most
// cap_pts points and cap_counts counts; returns the number of contours and
// sets *total_pts, so a caller whose buffers were too small can retry.
int64_t external_contours(const uint8_t* mask, int64_t h, int64_t w, int64_t* pts,
                          int64_t cap_pts, int64_t* counts, int64_t cap_counts,
                          int64_t* total_pts) {
  auto borders = external_borders(mask, h, w);
  int64_t n = 0;
  for (size_t k = 0; k < borders.size(); ++k) {
    if ((int64_t)k < cap_counts) counts[k] = (int64_t)borders[k].size();
    for (const Pt& p : borders[k]) {
      if (n < cap_pts) {
        pts[2 * n] = p.x;
        pts[2 * n + 1] = p.y;
      }
      ++n;
    }
  }
  *total_pts = n;
  return (int64_t)borders.size();
}

}  // extern "C"
