// Baseline JPEG decoding with the arithmetic of libjpeg(-turbo)'s defaults,
// without libjpeg.
//
// The JAX package reads images with cv2.imread / cv2.imdecode, which call
// libjpeg-turbo with its default decompression parameters. This file gives the
// same pixels, step for step:
//   - Huffman-coded sequential DCT (SOF0, SOF1), 8-bit samples, 1 or 3
//     components, interleaved or not, restart intervals (DRI / RSTn), 8- or
//     16-bit quantization tables;
//   - jidctint.c's jpeg_idct_islow (JDCT_ISLOW) with its range-limit table;
//   - jdsample.c's upsamplers: fancy (triangle) h2v1, h1v2 and h2v2, plain
//     replication where libjpeg falls back to it (a downsampled width of at
//     most 2) and for other integral factors; image edges replicated as
//     jdmainct.c's context rows do;
//   - jdcolor.c's fixed-point YCbCr -> RGB tables (and rgb_gray_convert's
//     for an RGB-coded file read as grey); a colour file read as grey is its
//     Y plane; a grey file read as colour is replicated;
//   - OpenCV's ApplyExifOrientation for the EXIF Orientation tag (1..8).
// Everything else is refused with a message naming the mode: progressive,
// arithmetic, lossless and hierarchical processes, precisions other than 8
// bits, 2 or 4 components (CMYK / YCCK). A stream that ends before its last
// MCU, or lacks its EOI marker, is refused as truncated (libjpeg pads it with
// grey and warns).
//
// C interface: jpeg_probe (the output size) and jpeg_decode; both return 0 or
// -1 with a message in `err`.
//
// Build: with the other sources of divergen_tpu_torch/native.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag index -> natural index, with libjpeg's 16 guard entries
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18];  // value index of the first code of each length, minus that code
  uint8_t vals[256];
  uint16_t look[1 << 9];  // (length << 8) | value for codes of at most 9 bits; 0: longer
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;        // blocks in the coefficient plane
  int dw = 0, dh = 0;        // downsampled width and height (jdiv_round_up)
  int dc = 0;
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw * 8 by bh * 8 samples after the IDCT
};

struct Decoder {
  const uint8_t* buf;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0, orientation = 1, adobe = -1;
  bool jfif = false, frame = false, orientation_seen = false;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc_tab[4], ac_tab[4];
  Component comp[3];

  // entropy-coded segment reader
  uint64_t bitbuf = 0;
  int bitcnt = 0;         // valid bits in bitbuf (real or zero fill)
  int64_t fill_bits = 0;  // zero bits fed past the end of the segment
  bool hit_marker = false;

  Decoder(const uint8_t* b, size_t len) : buf(b), n(len) {}

  int byte() {
    if (pos >= n) throw Error("truncated: the file ends inside a header");
    return buf[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // next marker code; skips fill bytes. Bytes between markers outside a scan
  // are tolerated as libjpeg does (it warns about them).
  int next_marker() {
    for (;;) {
      int c = byte();
      if (c != 0xFF) continue;
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_app1(size_t end) {
    // EXIF: "Exif\0\0" then a TIFF header; only IFD0's Orientation is read
    if (orientation_seen || end - pos < 14) return;
    const uint8_t* p = buf + pos;
    if (std::memcmp(p, "Exif\0\0", 6) != 0) return;
    orientation_seen = true;
    const uint8_t* t = p + 6;
    size_t tn = end - pos - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto u16 = [&](size_t o) -> uint32_t {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto u32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) | ((uint32_t)t[o + 2] << 16) |
                      ((uint32_t)t[o + 3] << 24)
                : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) | ((uint32_t)t[o + 2] << 8) |
                      (uint32_t)t[o + 3];
    };
    if (u16(2) != 42) return;
    size_t ifd = u32(4);
    if (ifd + 2 > tn) return;
    uint32_t count = u16(ifd);
    for (uint32_t i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > tn) return;
      if (u16(e) != 0x0112) continue;
      uint32_t type = u16(e + 2);
      uint32_t value = type == 3 ? u16(e + 8) : type == 4 ? u32(e + 8) : 0;
      if (value >= 1 && value <= 8) orientation = (int)value;
      return;
    }
  }

  void read_app14(size_t end) {
    if (end - pos >= 12 && std::memcmp(buf + pos, "Adobe", 5) == 0) adobe = buf[pos + 11];
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Error("bad DQT table");
      for (int k = 0; k < 64; ++k) quant[tq][kNatural[k]] = (uint16_t)(pq ? word() : byte());
      quant_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("bad DHT table");
      int bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += bits[l] = byte();
      if (total > 256) throw Error("bad DHT table: more than 256 codes");
      Huffman& h = tc ? ac_tab[th] : dc_tab[th];
      for (int i = 0; i < total; ++i) h.vals[i] = (uint8_t)byte();
      // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
      int code = 0, k = 0;
      std::memset(h.look, 0, sizeof(h.look));
      for (int l = 1; l <= 16; ++l) {
        if (bits[l]) {
          h.valoffset[l] = k - code;
          for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
            if (l <= 9) {
              int lo = code << (9 - l), hi = (code + 1) << (9 - l);
              for (int c = lo; c < hi; ++c) h.look[c] = (uint16_t)((l << 8) | h.vals[k]);
            }
          }
          h.maxcode[l] = code - 1;
        } else {
          h.maxcode[l] = -1;
        }
        if (bits[l] && code >= (1 << l)) throw Error("bad DHT table: over-subscribed code lengths");
        code <<= 1;
      }
      h.maxcode[17] = 0x7FFFFFFF;  // sentinel: a code longer than 16 bits is an error
      h.defined = true;
    }
  }

  void read_sof(size_t end) {
    if (frame) throw Error("more than one frame header");
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8)
      throw Error(std::to_string(precision) + "-bit samples (only 8-bit JPEG is supported)");
    if (ncomp == 4) throw Error("4-component (CMYK/YCCK) JPEG");
    if (ncomp != 1 && ncomp != 3)
      throw Error(std::to_string(ncomp) + "-component JPEG (only 1 or 3 components)");
    if (height == 0) throw Error("a DNL-defined height (0 in the frame header)");
    if (width == 0) throw Error("a zero image width");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = byte();
      int hv = byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        throw Error("bad sampling factors or quantization table in the frame header");
      if (k.h > hmax) hmax = k.h;
      if (k.v > vmax) vmax = k.v;
    }
    if (pos != end) throw Error("bad frame header length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      if (hmax % k.h || vmax % k.v)
        throw Error("fractional sampling factors (a component's factor does not divide the "
                    "largest)");
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }
    frame = true;
  }

  // -- entropy-coded data --------------------------------------------------
  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    fill_bits = 0;
    hit_marker = false;
  }

  void fill() {
    while (bitcnt <= 56) {
      int c = 0;
      if (!hit_marker) {
        if (pos >= n) {
          hit_marker = true;
        } else if (buf[pos] == 0xFF) {
          size_t q = pos + 1;
          while (q < n && buf[q] == 0xFF) ++q;  // fill bytes before a marker
          if (q < n && buf[q] == 0) {
            c = 0xFF;
            pos = q + 1;
          } else {
            pos = q - 1;  // leave the marker for the caller
            hit_marker = true;
          }
        } else {
          c = buf[pos++];
        }
      }
      if (hit_marker) fill_bits += 8;
      bitbuf |= (uint64_t)c << (56 - bitcnt);
      bitcnt += 8;
    }
  }

  int bits(int s) {
    if (s == 0) return 0;
    if (bitcnt < s) fill();
    int v = (int)(bitbuf >> (64 - s));
    bitbuf <<= s;
    bitcnt -= s;
    return v;
  }

  int decode(const Huffman& h) {
    if (bitcnt < 16) fill();
    int peek = (int)(bitbuf >> (64 - 9));
    int e = h.look[peek];
    if (e) {
      int l = e >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      return e & 0xFF;
    }
    int code = (int)(bitbuf >> (64 - 10)), l = 10;
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = (int)(bitbuf >> (64 - l));
    }
    if (l > 16) corrupt("a Huffman code longer than 16 bits");
    bitbuf <<= l;
    bitcnt -= l;
    return h.vals[code + h.valoffset[l]];
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  // an error inside entropy-coded data; past the end of the file it is a truncation
  [[noreturn]] void corrupt(const std::string& what) const {
    if (hit_marker && pos >= n) throw Error("truncated: the file ends inside the image data");
    throw Error("corrupt entropy data (" + what + ")");
  }

  void decode_block(Component& k, int16_t* blk) {
    const Huffman& dt = dc_tab[k.td];
    const Huffman& at = ac_tab[k.ta];
    int s = decode(dt);
    if (s > 15) corrupt("a DC magnitude above 15 bits");
    int diff = s ? extend(bits(s), s) : 0;
    k.dc += diff;
    blk[0] = (int16_t)k.dc;
    for (int i = 1; i < 64; ++i) {
      int rs = decode(at);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  // bits consumed past the segment's last byte: the stream ended early
  bool overran() const { return hit_marker && fill_bits - bitcnt > 0; }

  void expect_restart(int index) {
    // the remaining bits of the interval are padding; the marker comes next
    if (overran()) throw Error("truncated: the entropy-coded data ends inside an MCU");
    reset_bits();
    skip_to_marker();  // libjpeg skips extraneous bytes here too (with a warning)
    if (pos + 1 >= n) throw Error("truncated: the file ends before a restart marker");
    if (buf[pos + 1] != (0xD0 | (index & 7)))
      throw Error("corrupt entropy data (restart marker RST" + std::to_string(index & 7) +
                  " missing)");
    pos += 2;
  }

  void read_scan() {
    if (!frame) throw Error("a scan before the frame header");
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) throw Error("bad scan header");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int cs = byte(), t = byte();
      Component* k = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cs) k = &comp[c];
      if (!k) throw Error("a scan names a component the frame lacks");
      k->td = t >> 4;
      k->ta = t & 15;
      if (k->td > 3 || k->ta > 3 || !dc_tab[k->td].defined || !ac_tab[k->ta].defined)
        throw Error("a scan uses an undefined Huffman table");
      if (!quant_defined[k->tq]) throw Error("a component uses an undefined quantization table");
      sc[i] = k;
    }
    int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) throw Error("progressive JPEG (spectral selection)");
    reset_bits();
    for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
    int64_t total, per_row;
    if (ns == 1) {  // non-interleaved: one block per MCU over the component's own grid
      per_row = (sc[0]->dw + 7) / 8;
      total = per_row * ((sc[0]->dh + 7) / 8);
    } else {
      per_row = mcux;
      total = (int64_t)mcux * mcuy;
    }
    int rst_index = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart && m && m % restart == 0) {
        expect_restart(rst_index++);
        for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
      }
      int64_t my = m / per_row, mx = m % per_row;
      if (ns == 1) {
        Component& k = *sc[0];
        decode_block(k, &k.coef[((size_t)my * k.bw + mx) * 64]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& k = *sc[i];
          for (int by = 0; by < k.v; ++by)
            for (int bx = 0; bx < k.h; ++bx) {
              size_t row = (size_t)my * k.v + by, col = (size_t)mx * k.h + bx;
              decode_block(k, &k.coef[(row * k.bw + col) * 64]);
            }
        }
      }
    }
    if (overran()) throw Error("truncated: the entropy-coded data ends inside an MCU");
    skip_to_marker();  // the segment's padding bits are done
    if (pos >= n) throw Error("truncated: the file ends after the entropy-coded data");
  }

  // pos at the 0xFF of the next marker, or at n
  void skip_to_marker() {
    while (pos < n && !(buf[pos] == 0xFF && pos + 1 < n && buf[pos + 1] != 0 &&
                        buf[pos + 1] != 0xFF))
      ++pos;
  }

  // the whole stream, or (headers_only) up to the first scan
  void parse(bool headers_only) {
    if (n < 2 || buf[0] != 0xFF || buf[1] != 0xD8) throw Error("not a JPEG (no SOI marker)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m;
      try {
        m = next_marker();
      } catch (const Error&) {
        throw Error(scanned ? "truncated: no EOI marker after the last scan"
                            : "truncated: the file ends before the image data");
      }
      if (m == 0xD9) {  // EOI
        if (!scanned) throw Error("no image data before EOI");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn outside a scan
      if (m == 0xD8) throw Error("a second SOI marker");
      if (m == 0xDA) {
        if (headers_only) {
          if (!frame) throw Error("a scan before the frame header");
          return;
        }
        read_scan();
        scanned = true;
        continue;
      }
      int len = word();
      if (len < 2) throw Error("bad marker segment length");
      size_t end = pos + (size_t)len - 2;
      if (end > n) throw Error("truncated: a marker segment runs past the end of the file");
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(end);
          break;
        case 0xC2:
          throw Error("progressive JPEG (SOF2)");
        case 0xC3:
          throw Error("lossless JPEG (SOF3)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          throw Error("hierarchical (differential) JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          throw Error("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xCC:
          throw Error("arithmetic-coded JPEG (DAC)");
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          if (len != 4) throw Error("bad DRI length");
          restart = word();
          break;
        case 0xE0:
          if (end - pos >= 5 && std::memcmp(buf + pos, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xE1:
          read_app1(end);
          break;
        case 0xEE:
          read_app14(end);
          break;
        default:
          break;  // APPn, COM, and the rest: skipped
      }
      if (pos > end) throw Error("bad marker segment length");
      pos = end;
    }
  }

  // -- reconstruction --------------------------------------------------------
  bool rgb_coded() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe >= 0) return adobe == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  void idct_all(int ncomp_needed) {
    static uint8_t limit[1024];
    static bool init = false;
    if (!init) {  // jdmaster.c prepare_range_limit_table, post-IDCT half
      for (int i = 0; i < 1024; ++i) {
        int v = i < 512 ? i : i - 1024;  // the sign of a value masked by 1023
        int s = v + 128;
        limit[i] = (uint8_t)(s < 0 ? 0 : s > 255 ? 255 : s);
      }
      init = true;
    }
    for (int c = 0; c < ncomp_needed; ++c) {
      Component& k = comp[c];
      size_t pw = (size_t)k.bw * 8;
      k.plane.assign(pw * k.bh * 8, 0);
      for (int by = 0; by < k.bh; ++by)
        for (int bx = 0; bx < k.bw; ++bx)
          idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], quant[k.tq],
                     &k.plane[(size_t)by * 8 * pw + (size_t)bx * 8], pw, limit);
    }
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride,
                         const uint8_t* limit) {
    // jidctint.c: CONST_BITS 13, PASS1_BITS 2
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* w = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dc = (int)((int64_t)ip[0] * qp[0] * 4);
        for (int r = 0; r < 8; ++r) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 11;  // CONST_BITS - PASS1_BITS
      const int64_t rd = int64_t(1) << (sh - 1);
      w[0] = (int)((tmp10 + tmp3 + rd) >> sh);
      w[56] = (int)((tmp10 - tmp3 + rd) >> sh);
      w[8] = (int)((tmp11 + tmp2 + rd) >> sh);
      w[48] = (int)((tmp11 - tmp2 + rd) >> sh);
      w[16] = (int)((tmp12 + tmp1 + rd) >> sh);
      w[40] = (int)((tmp12 - tmp1 + rd) >> sh);
      w[24] = (int)((tmp13 + tmp0 + rd) >> sh);
      w[32] = (int)((tmp13 - tmp0 + rd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + (size_t)r * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t v = limit[(int)(((int64_t)w[0] + 16) >> 5) & 1023];
        for (int c = 0; c < 8; ++c) o[c] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192, tmp1 = ((int64_t)w[0] - w[4]) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 18;  // CONST_BITS + PASS1_BITS + 3
      const int64_t rd = int64_t(1) << (sh - 1);
      o[0] = limit[(int)((tmp10 + tmp3 + rd) >> sh) & 1023];
      o[7] = limit[(int)((tmp10 - tmp3 + rd) >> sh) & 1023];
      o[1] = limit[(int)((tmp11 + tmp2 + rd) >> sh) & 1023];
      o[6] = limit[(int)((tmp11 - tmp2 + rd) >> sh) & 1023];
      o[2] = limit[(int)((tmp12 + tmp1 + rd) >> sh) & 1023];
      o[5] = limit[(int)((tmp12 - tmp1 + rd) >> sh) & 1023];
      o[3] = limit[(int)((tmp13 + tmp0 + rd) >> sh) & 1023];
      o[4] = limit[(int)((tmp13 - tmp0 + rd) >> sh) & 1023];
    }
  }

  // One component at full resolution (width x height), libjpeg's upsampler
  // for its factors.
  std::vector<uint8_t> upsample(const Component& k) const {
    const size_t pw = (size_t)k.bw * 8;
    const int fh = hmax / k.h, fv = vmax / k.v;
    const int dw = k.dw, dh = k.dh;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int {  // the downsampled plane, edges replicated
      y = y < 0 ? 0 : y >= dh ? dh - 1 : y;
      return k.plane[(size_t)y * pw + x];
    };
    std::vector<uint8_t> row((size_t)dw * fh + 2);
    for (int oy = 0; oy < height; ++oy) {
      uint8_t* o = &out[(size_t)oy * width];
      if (fh == 1 && fv == 1) {
        std::memcpy(o, &k.plane[(size_t)oy * pw], width);
      } else if (fh == 2 && fv == 1) {
        int y = oy;
        if (dw > 2) {  // h2v1_fancy_upsample
          for (int x = 0; x < dw; ++x) {
            int v = at(y, x) * 3;
            int l = x ? at(y, x - 1) : at(y, x), r = x + 1 < dw ? at(y, x + 1) : at(y, x);
            row[2 * x] = (uint8_t)(x ? (v + l + 1) >> 2 : at(y, x));
            row[2 * x + 1] = (uint8_t)(x + 1 < dw ? (v + r + 2) >> 2 : at(y, x));
          }
        } else {
          for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = (uint8_t)at(y, x);
        }
        std::memcpy(o, row.data(), width);
      } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
        int y = oy >> 1;
        int nb = (oy & 1) ? y + 1 : y - 1, bias = (oy & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x) o[x] = (uint8_t)((at(y, x) * 3 + at(nb, x) + bias) >> 2);
      } else if (fh == 2 && fv == 2) {
        int y = oy >> 1;
        if (dw > 2) {  // h2v2_fancy_upsample
          int nb = (oy & 1) ? y + 1 : y - 1;
          auto colsum = [&](int x) { return at(y, x) * 3 + at(nb, x); };
          int last = colsum(0), cur = last;
          for (int x = 0; x < dw; ++x) {
            int next = x + 1 < dw ? colsum(x + 1) : cur;
            row[2 * x] = (uint8_t)(x ? (cur * 3 + last + 8) >> 4 : (cur * 4 + 8) >> 4);
            row[2 * x + 1] =
                (uint8_t)(x + 1 < dw ? (cur * 3 + next + 7) >> 4 : (cur * 4 + 7) >> 4);
            last = cur;
            cur = next;
          }
        } else {  // h2v2_upsample
          for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = (uint8_t)at(y, x);
        }
        std::memcpy(o, row.data(), width);
      } else {  // int_upsample: replication by integral factors
        int y = oy / fv;
        for (int x = 0; x < width; ++x) o[x] = (uint8_t)at(y, x / fh);
      }
    }
    return out;
  }

  std::vector<uint8_t> luma() const {
    const Component& k = comp[0];
    if (k.h == hmax && k.v == vmax) {
      std::vector<uint8_t> out((size_t)width * height);
      for (int y = 0; y < height; ++y)
        std::memcpy(&out[(size_t)y * width], &k.plane[(size_t)y * k.bw * 8], width);
      return out;
    }
    return upsample(k);
  }

  // (height, width, channels) before the orientation
  std::vector<uint8_t> pixels(bool gray) {
    const size_t np = (size_t)width * height;
    if (ncomp == 1) {
      idct_all(1);
      std::vector<uint8_t> y = luma();
      if (gray) return y;
      std::vector<uint8_t> out(np * 3);
      for (size_t i = 0; i < np; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return out;
    }
    bool rgb = rgb_coded();
    if (gray && !rgb) {  // grayscale_convert: the Y plane itself
      idct_all(1);
      return luma();
    }
    idct_all(3);
    std::vector<uint8_t> p0 = upsample(comp[0]), p1 = upsample(comp[1]), p2 = upsample(comp[2]);
    const int SB = 16;
    const int32_t HALF = 1 << (SB - 1);
    auto FIX = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
    if (gray) {  // rgb_gray_convert
      std::vector<uint8_t> out(np);
      for (size_t i = 0; i < np; ++i)
        out[i] = (uint8_t)((FIX(0.29900) * p0[i] + FIX(0.58700) * p1[i] +
                            FIX(0.11400) * p2[i] + HALF) >> SB);
      return out;
    }
    std::vector<uint8_t> out(np * 3);
    if (rgb) {
      for (size_t i = 0; i < np; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return out;
    }
    // jdcolor.c build_ycc_rgb_table + ycc_rgb_convert
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int x = i - 128;
      cr_r[i] = (int)((FIX(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((FIX(1.77200) * x + HALF) >> SB);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < np; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
    return out;
  }
};

// OpenCV's ApplyExifOrientation: flips and transposes of an (h, w, c) image
void orient(const std::vector<uint8_t>& in, int h, int w, int c, int orientation, uint8_t* out) {
  bool transpose = orientation >= 5;
  // after the optional transpose: flip x for 2, 3, 6, 7; flip y for 3, 4, 7, 8
  bool fx = orientation == 2 || orientation == 3 || orientation == 6 || orientation == 7;
  bool fy = orientation == 3 || orientation == 4 || orientation == 7 || orientation == 8;
  int oh = transpose ? w : h, ow = transpose ? h : w;
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int ty = fy ? oh - 1 - y : y, tx = fx ? ow - 1 - x : x;
      int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
      std::memcpy(out + ((size_t)y * ow + x) * c, &in[((size_t)sy * w + sx) * c], c);
    }
}

void set_error(char* err, int64_t cap, const char* msg) {
  if (err && cap > 0) {
    std::strncpy(err, msg, (size_t)cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// dims[0..2] = output height, width, channels (after the EXIF orientation);
// dims[3] = the orientation; dims[4] = components in the file
int64_t jpeg_probe(const uint8_t* buf, int64_t n, int64_t gray, int64_t* dims, char* err,
                   int64_t errcap) {
  try {
    Decoder d(buf, (size_t)n);
    d.parse(true);
    bool t = d.orientation >= 5;
    dims[0] = t ? d.width : d.height;
    dims[1] = t ? d.height : d.width;
    dims[2] = gray ? 1 : 3;
    dims[3] = d.orientation;
    dims[4] = d.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
}

// out: dims from jpeg_probe, uint8 (h, w, c); returns 0, or -1 with err set
int64_t jpeg_decode(const uint8_t* buf, int64_t n, int64_t gray, uint8_t* out, int64_t cap,
                    char* err, int64_t errcap) {
  try {
    Decoder d(buf, (size_t)n);
    d.parse(false);
    int c = gray ? 1 : 3;
    if ((int64_t)d.width * d.height * c > cap) throw Error("output buffer too small");
    std::vector<uint8_t> px = d.pixels(gray != 0);
    orient(px, d.height, d.width, c, d.orientation, out);
    return 0;
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory");
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
}

}  // extern "C"
