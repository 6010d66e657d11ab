// Polygon rasterization with the pixel set of OpenCV's fillPoly (8-connected
// outline, integer vertices, shift 0), without OpenCV.
//
// The JAX package rasterizes COCO polygons with cv2.fillPoly on vertices
// rounded to int32 (divergen_tpu/utils/mask_codec.py:polygons_to_bitmask).
// fillPoly does not fill "pixel centres inside": it draws every edge as an
// 8-connected Bresenham line (clipped to the frame) and then fills the
// scanline spans between the edges, walked in 16.16 fixed point. Both halves
// are reproduced here step for step (CollectPolyEdges, Line through
// LineIterator with clipLine, FillEdgeCollection), so boundary pixels,
// slivers, two-point and zero-area polygons and vertices off the frame give
// the same bits.
//
// Build: with cocoeval.cpp and mask_codec.cpp (divergen_tpu_torch/native).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>

namespace {

constexpr int kShift = 16;  // XY_SHIFT
constexpr int64_t kOne = int64_t(1) << kShift;

struct Edge {
  int y0, y1;
  int64_t x, dx;
  Edge* next;
};

// clipLine on (0..w-1, 0..h-1): false if the segment misses the frame
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
  const int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

int saturate_int(int64_t v) {
  return (int)std::min<int64_t>(std::max<int64_t>(v, INT_MIN), INT_MAX);
}

// Line(img, p1, p2, color, 8): LineIterator(leftToRight) over the clipped segment
void draw_line(uint8_t* img, int w, int h, int64_t ax, int64_t ay, int64_t bx, int64_t by) {
  int64_t x1 = saturate_int(ax), y1 = saturate_int(ay);
  int64_t x2 = saturate_int(bx), y2 = saturate_int(by);
  if ((uint64_t)x1 >= (uint64_t)w || (uint64_t)x2 >= (uint64_t)w ||
      (uint64_t)y1 >= (uint64_t)h || (uint64_t)y2 >= (uint64_t)h) {
    if (!clip_line(w, h, x1, y1, x2, y2)) return;
  }
  int64_t dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  int64_t sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  const int64_t plus_delta = dx + dx, minus_delta = -(dy + dy);
  int64_t x = x1, y = y1;
  for (int64_t i = 0; i <= dx; ++i) {
    img[y * w + x] = 1;
    const bool diag = err < 0;
    err += minus_delta + (diag ? plus_delta : 0);
    // major axis every step, minor axis on a diagonal step
    if (vert) {
      y += sy;
      if (diag) x += 1;
    } else {
      x += 1;
      if (diag) y += sy;
    }
  }
}

void collect_edges(uint8_t* img, int w, int h, const int64_t* pts, int64_t n,
                   std::vector<Edge>& edges) {
  int64_t p0x = pts[2 * (n - 1)] << kShift, p0y = pts[2 * (n - 1) + 1];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p1x = pts[2 * i] << kShift, p1y = pts[2 * i + 1];
    int64_t t0x = (p0x + (kOne >> 1)) >> kShift, t0y = p0y;
    int64_t t1x = (p1x + (kOne >> 1)) >> kShift, t1y = p1y;
    draw_line(img, w, h, t0x, t0y, t1x, t1y);
    int64_t c0y = p0y, c1y = p1y;
    // the edge of a line that leaves the frame runs between its clipped ends
    // (their rows only where they differ; clipLine's result is not checked)
    if ((uint64_t)t0x >= (uint64_t)w || (uint64_t)t1x >= (uint64_t)w ||
        (uint64_t)t0y >= (uint64_t)h || (uint64_t)t1y >= (uint64_t)h) {
      clip_line(w, h, t0x, t0y, t1x, t1y);
      if (t0y != t1y) {
        c0y = t0y;
        c1y = t1y;
      }
    }
    const int64_t c0x = t0x << kShift, c1x = t1x << kShift;
    if (p0y != p1y) {
      Edge e;
      e.dx = (c1x - c0x) / (c1y - c0y);
      if (p0y < p1y) {
        e.y0 = (int)p0y;
        e.y1 = (int)p1y;
        e.x = c0x + (e.y0 - c0y) * e.dx;
      } else {
        e.y0 = (int)p1y;
        e.y1 = (int)p0y;
        e.x = c1x + (e.y0 - c1y) * e.dx;
      }
      e.next = nullptr;
      edges.push_back(e);
    }
    p0x = p1x;
    p0y = p1y;
  }
}

void fill_edges(uint8_t* img, int w, int h, std::vector<Edge>& edges) {
  const int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = -1, x_min = INT64_MAX;  // x_max starts at 0xFFFFFFFFFFFFFFFF
  for (const Edge& e : edges) {
    const int64_t x1 = e.x + (int64_t)(e.y1 - e.y0) * e.dx;
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
    x_min = std::min(x_min, std::min(e.x, x1));
    x_max = std::max(x_max, std::max(e.x, x1));
  }
  if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= ((int64_t)w << kShift)) return;
  std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
    if (a.y0 != b.y0) return a.y0 < b.y0;
    if (a.x != b.x) return a.x < b.x;
    return a.dx < b.dx;
  });
  Edge tmp;
  tmp.y0 = INT_MAX;
  tmp.next = nullptr;
  edges.push_back(tmp);  // the sentinel; no more pushes, so pointers stay valid
  int i = 0;
  Edge* e = &edges[0];
  y_max = std::min(y_max, h);
  for (int y = e->y0; y < y_max; ++y) {
    Edge *last, *prelast, *keep_prelast;
    int draw = 0;
    const bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {  // the edge ends above this row
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {  // an edge starts on this row
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          // the span's pixels: ceil of the left edge to floor of the right
          if (keep_prelast->x > prelast->x) {
            x1 = (int)((prelast->x + kOne - 1) >> kShift);
            x2 = (int)(keep_prelast->x >> kShift);
          } else {
            x1 = (int)((keep_prelast->x + kOne - 1) >> kShift);
            x2 = (int)(prelast->x >> kShift);
          }
          if (x1 < w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= w) x2 = w - 1;
            std::fill(img + (int64_t)y * w + x1, img + (int64_t)y * w + x2 + 1, (uint8_t)1);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // bubble sort of the active list by x
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      Edge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        Edge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

}  // namespace

extern "C" {

// OR one polygon (n integer vertices, x0 y0 x1 y1 ...) into an (h, w) uint8
// mask, as cv2.fillPoly(mask, [pts], 1) does. Returns 0.
int64_t fill_polygon(uint8_t* mask, int64_t h, int64_t w, const int64_t* pts, int64_t n) {
  if (n <= 0) return 0;
  std::vector<Edge> edges;
  edges.reserve(n + 1);
  collect_edges(mask, (int)w, (int)h, pts, n, edges);
  fill_edges(mask, (int)w, (int)h, edges);
  return 0;
}

}  // extern "C"
