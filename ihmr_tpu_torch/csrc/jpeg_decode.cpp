// Baseline JPEG decoding for ihmr_tpu_torch/data/image_io.py (C, loaded with
// ctypes by ihmr_tpu_torch/data/native.py; built with g++ by
// ihmr_tpu_torch/build.py with -ffp-contract=off). Python parses the
// markers; this file holds the two stages that touch every coefficient and
// pixel, with libjpeg-turbo's arithmetic at its default settings, so the
// result is the one cv2.imread returns, byte for byte:
//
// jpeg_decode_scan: the Huffman entropy decoding of one sequential scan
// into quantised coefficients in natural order, with restart intervals.
// Past a marker inside the entropy-coded data the bit reader supplies zero
// bits, as libjpeg does with a truncated segment.
//
// jpeg_finish: per component, the "islow" integer inverse DCT of jidctint.c
// (13-bit constants, 2 extra bits in the first pass, the result through the
// post-IDCT range-limit table); then jdsample.c's upsampling of each
// component to the largest sampling factors ("fancy" triangle filters for
// h2v1 and h2v2 when the component is wider than 2 samples, and for h1v2;
// replication for other integer factors and for narrow components); then
// jdcolor.c's YCbCr -> BGR with its 16-bit fixed-point tables, or gray
// replicated into three channels.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zig-zag index -> natural index; entries past 63 absorb corrupt run lengths
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  int32_t maxcode[18];    // largest code of each length, -1 if none; maxcode[17] ends the search
  int32_t valoffset[18];  // index of a length's first value minus its first code
  uint8_t values[256];
  uint8_t look_len[1 << kLookBits];  // code length of a kLookBits-bit prefix, 0 if longer
  uint8_t look_val[1 << kLookBits];

  // bits[16]: codes of each length 1..16; values follow (libjpeg's jpeg_make_d_derived_tbl)
  void build(const uint8_t* spec) {
    const uint8_t* bits = spec;
    std::memcpy(values, spec + 16, 256);
    int32_t code = 0;
    int p = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - code;
        for (int i = 0; i < bits[l - 1]; ++i, ++p, ++code) {
          if (l <= kLookBits) {
            const int shift = kLookBits - l;
            for (int k = 0; k < (1 << shift); ++k) {
              look_len[(code << shift) | k] = static_cast<uint8_t>(l);
              look_val[(code << shift) | k] = values[p & 255];
            }
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
        valoffset[l] = 0;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    valoffset[17] = 0;
  }
};

struct BitReader {
  const uint8_t* data;
  long len;
  long pos;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          long q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;  // fill bytes before a marker
          if (q < len && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // leave pos on the marker's first 0xFF
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
    }
  }
  uint32_t peek(int n) {
    if (count < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    count -= n;
  }
  int32_t bits(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return static_cast<int32_t>(v);
  }
  int decode(const Huffman& h) {
    const uint32_t look = peek(16);
    const int l9 = h.look_len[look >> (16 - kLookBits)];
    if (l9) {
      skip(l9);
      return h.look_val[look >> (16 - kLookBits)];
    }
    int l = kLookBits + 1;
    while (static_cast<int32_t>(look >> (16 - std::min(l, 16))) > h.maxcode[l]) ++l;
    if (l > 16) {  // a corrupt code: libjpeg returns 0 and goes on
      skip(16);
      return 0;
    }
    const int32_t code = static_cast<int32_t>(look >> (16 - l));
    skip(l);
    return h.values[(code + h.valoffset[l]) & 255];
  }
  // drop the buffered bits and step over the next marker if it is RSTn
  void restart() {
    buf = 0;
    count = 0;
    if (!at_marker) {
      while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF)) ++pos;
    }
    at_marker = false;
    if (pos + 1 < len && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
  }
};

inline int32_t extend(int32_t v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// islow inverse DCT (jidctint.c)
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c's prepare_range_limit_table, seen from the IDCT: index
// (value & 1023) -> sample, value + 128 clamped for |value| < 512
struct RangeLimit {
  uint8_t table[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i + 128 : i - 1024 + 128;  // i in [512, 1024) stands for i - 1024
      table[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, long stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int dc = (in[0] * q[0]) * (1 << PASS1_BITS);
      for (int k = 0; k < 8; ++k) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = CONST_BITS - PASS1_BITS;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    constexpr int s = CONST_BITS + PASS1_BITS + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.table[descale(tmp10 + tmp3, s) & 1023];
    o[7] = kRange.table[descale(tmp10 - tmp3, s) & 1023];
    o[1] = kRange.table[descale(tmp11 + tmp2, s) & 1023];
    o[6] = kRange.table[descale(tmp11 - tmp2, s) & 1023];
    o[2] = kRange.table[descale(tmp12 + tmp1, s) & 1023];
    o[5] = kRange.table[descale(tmp12 - tmp1, s) & 1023];
    o[3] = kRange.table[descale(tmp13 + tmp0, s) & 1023];
    o[4] = kRange.table[descale(tmp13 - tmp0, s) & 1023];
  }
}

struct Plane {
  std::vector<uint8_t> px;
  int width = 0, height = 0;  // allocated size
  uint8_t at(int y, int x) const { return px[static_cast<size_t>(y) * width + x]; }
};

// One component (dw x dh real samples in `in`, factors h, v of hmax, vmax)
// -> a (height x width) plane at full resolution, jdsample.c's way.
void upsample(const Plane& in, int dw, int dh, int h, int v, int hmax, int vmax, int width, int height,
              Plane& out) {
  out.width = width;
  out.height = height;
  out.px.assign(static_cast<size_t>(width) * height, 0);
  // the row above the first is the first, the row below the last real row is that row
  auto row = [&](int y) { return std::min(std::max(y, 0), dh - 1); };
  // a column past the last real one repeats it (what libjpeg-turbo's vector code inserts)
  auto col = [&](int y, int x) { return in.at(row(y), std::min(x, dw - 1)); };
  const bool fancy_h2 = h * 2 == hmax && dw > 2;
  for (int oy = 0; oy < height; ++oy) {
    uint8_t* o = out.px.data() + static_cast<size_t>(oy) * width;
    if (h == hmax && v == vmax) {
      for (int x = 0; x < width; ++x) o[x] = in.at(oy, x);
    } else if (h * 2 == hmax && v == vmax && fancy_h2) {  // h2v1 fancy
      for (int x = 0; x < width; ++x) {
        const int ix = x >> 1;
        const int here = in.at(oy, ix) * 3;
        if (x & 1) {
          o[x] = static_cast<uint8_t>((here + col(oy, ix + 1) + 2) >> 2);
        } else {
          o[x] = static_cast<uint8_t>(ix == 0 ? here / 3 : (here + in.at(oy, ix - 1) + 1) >> 2);
        }
      }
    } else if (h == hmax && v * 2 == vmax) {  // h1v2 fancy
      const int iy = oy >> 1;
      const int other = (oy & 1) ? row(iy + 1) : row(iy - 1);
      const int bias = (oy & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((in.at(iy, x) * 3 + in.at(other, x) + bias) >> 2);
    } else if (h * 2 == hmax && v * 2 == vmax && fancy_h2) {  // h2v2 fancy
      const int iy = oy >> 1;
      const int other = (oy & 1) ? iy + 1 : iy - 1;
      auto colsum = [&](int ix) { return col(iy, ix) * 3 + col(other, ix); };
      for (int x = 0; x < width; ++x) {
        const int ix = x >> 1;
        const int here = colsum(ix);
        if (x & 1) {
          o[x] = static_cast<uint8_t>((here * 3 + colsum(ix + 1) + 7) >> 4);
        } else {
          o[x] = static_cast<uint8_t>(ix == 0 ? (here * 4 + 8) >> 4 : (here * 3 + colsum(ix - 1) + 8) >> 4);
        }
      }
    } else {  // integer factors: replication
      const int ry = oy / (vmax / v);
      for (int x = 0; x < width; ++x) o[x] = in.at(ry, x / (hmax / h));
    }
  }
}

}  // namespace

extern "C" {

// Decode one scan's entropy-coded data starting at data[pos].
// comps: per component of the scan, 7 int32: (frame component index, DC
// table 0-3, AC table 0-3, h, v, blocks per buffer row, unused);
// offsets: per component of the scan, its first coefficient in `coefs`;
// tables: 8 Huffman specs of 16 + 256 bytes (DC 0-3, then AC 0-3);
// mcus_x * mcus_y MCUs (one block each when ns == 1). Returns the position
// of the first byte after the scan's data, or -1 on an undefined table.
long jpeg_decode_scan(const uint8_t* data, long len, long pos, int ns, const int32_t* comps, const int64_t* offsets,
                      const uint8_t* tables, int mcus_x, int mcus_y, int restart_interval, int16_t* coefs) {
  Huffman dc[4], ac[4];
  bool used[8] = {false};
  for (int i = 0; i < ns; ++i) {
    used[comps[7 * i + 1]] = true;
    used[4 + comps[7 * i + 2]] = true;
  }
  for (int t = 0; t < 8; ++t) {
    if (!used[t]) continue;
    int total = 0;
    for (int l = 0; l < 16; ++l) total += tables[t * 272 + l];
    if (total == 0 || total > 256) return -1;
    (t < 4 ? dc[t] : ac[t - 4]).build(tables + t * 272);
  }
  BitReader br{data, len, pos};
  int pred[4] = {0, 0, 0, 0};
  long mcu = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval && mcu && mcu % restart_interval == 0) {
        br.restart();
        std::fill(pred, pred + 4, 0);
      }
      for (int i = 0; i < ns; ++i) {
        const int32_t* c = comps + 7 * i;
        const int h = ns == 1 ? 1 : c[3], v = ns == 1 ? 1 : c[4], bw = c[5];
        const Huffman& hd = dc[c[1]];
        const Huffman& ha = ac[c[2]];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int16_t* blk = coefs + offsets[i] + (static_cast<long>(my * v + by) * bw + (mx * h + bx)) * 64;
            int s = br.decode(hd);
            if (s) s = extend(br.bits(s), s);
            pred[i] += s;
            blk[0] = static_cast<int16_t>(pred[i]);
            for (int k = 1; k < 64; ++k) {
              const int rs = br.decode(ha);
              const int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
        }
      }
    }
  }
  return br.pos;
}

// The decoded coefficients -> a (height, width, 3) BGR image.
// comps: per component 4 int32 (h, v, blocks per row, block rows);
// quant: ncomp x 64 dequantisation factors in natural order.
// Returns 0, or 1 for a sampling layout it does not upsample.
int jpeg_finish(const int16_t* coefs, int ncomp, const int32_t* comps, const int64_t* offsets,
                const uint16_t* quant, int width, int height, int hmax, int vmax, uint8_t* out) {
  std::vector<Plane> full(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int h = comps[4 * c], v = comps[4 * c + 1], bw = comps[4 * c + 2], bh = comps[4 * c + 3];
    if (hmax % h || vmax % v) return 1;
    Plane plane;
    plane.width = bw * 8;
    plane.height = bh * 8;
    plane.px.resize(static_cast<size_t>(plane.width) * plane.height);
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx)
        idct_islow(coefs + offsets[c] + (static_cast<long>(by) * bw + bx) * 64, quant + 64 * c,
                   plane.px.data() + static_cast<size_t>(by) * 8 * plane.width + bx * 8, plane.width);
    const int dw = (width * h + hmax - 1) / hmax, dh = (height * v + vmax - 1) / vmax;
    upsample(plane, dw, dh, h, v, hmax, vmax, width, height, full[c]);
  }
  const long n = static_cast<long>(width) * height;
  if (ncomp == 1) {
    const uint8_t* y = full[0].px.data();
    for (long i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return 0;
  }
  // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
  constexpr int SCALEBITS = 16;
  constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
  auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  const uint8_t *Y = full[0].px.data(), *Cb = full[1].px.data(), *Cr = full[2].px.data();
  for (long i = 0; i < n; ++i) {
    const int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i + 2] = clamp(y + cr_r[cr]);
    out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
    out[3 * i] = clamp(y + cb_b[cb]);
  }
  return 0;
}

}  // extern "C"
