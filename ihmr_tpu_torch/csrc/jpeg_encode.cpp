// Baseline JPEG encoding for ihmr_tpu_torch/data/image_io.py (C, loaded with
// ctypes by ihmr_tpu_torch/data/native.py; built with g++ by
// ihmr_tpu_torch/build.py with -ffp-contract=off). It writes the bytes that
// cv2.imwrite / cv2.imencode(".jpg") write with their defaults, which are
// libjpeg-turbo's jpeg_set_defaults plus jpeg_set_quality(q, TRUE):
//
//   * markers (jcmarker.c): SOI; APP0 JFIF 1.01, density 1:1, unit 0; one
//     DQT per table (8-bit, zig-zag order); SOF0 with Y sampled 2x2 and Cb,
//     Cr 1x1 (4:2:0); one DHT per table in scan order (DC 0, AC 0, DC 1,
//     AC 1: the Annex K tables); SOS over the three components; EOI. No
//     restart markers, no optimised tables.
//   * quantisation tables (jcparam.c): the Annex K tables scaled by the
//     quality's percentage, (q * scale + 50) / 100, clamped to 1..255.
//   * colour conversion (jccolor.c): 16-bit fixed-point tables, the chroma
//     rounding ONE_HALF - 1.
//   * edge padding (jcprepro.c, jcsample.c): the image's last column is
//     replicated to whole blocks of each component before downsampling, an
//     odd last row is replicated into the last row pair, and each
//     component's last row (after downsampling) is replicated to whole
//     iMCU rows.
//   * downsampling (jcsample.c h2v2_downsample): the 2x2 sum plus a bias
//     that alternates 1, 2 along each output row, shifted right by 2.
//   * forward DCT (jfdctint.c): the "islow" integer DCT, 13-bit constants
//     and 2 extra bits in the first pass; quantisation (jcdctmgr.c) by
//     multiplication with libjpeg-turbo's 16-bit reciprocals of q * 8.
//   * coefficient buffering (jccoefct.c): a partial MCU's dummy blocks are
//     all zero with the DC of the block before them.
//   * entropy coding (jchuff.c): DC differences per component, AC runs with
//     ZRL and EOB, 0xFF followed by a stuffed 0x00, the last byte padded
//     with 1-bits.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zig-zag index -> natural index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K quantisation tables, natural order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K Huffman tables: code counts of lengths 1..16, then the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22,
    0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33,
    0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34,
    0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76,
    0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
    0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1,
    0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13,
    0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62,
    0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29,
    0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94,
    0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* values;
  int count;
  uint32_t code[256];
  int size[256];

  // jpeg_make_c_derived_tbl: canonical codes, lengths 1..16 in order
  HuffTable(const uint8_t* b, const uint8_t* v) : bits(b), values(v), count(0) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++count, ++c) {
        code[values[count]] = c;
        size[values[count]] = l;
      }
      c <<= 1;
    }
  }
};

// Bytes of the output, with the entropy coder's bit buffer (MSB first).
struct Writer {
  uint8_t* out;
  long capacity;
  long pos = 0;
  bool overflow = false;
  uint32_t acc = 0;
  int nbits = 0;

  void byte(uint8_t b) {
    if (pos < capacity) out[pos] = b;
    else overflow = true;
    ++pos;
  }
  void word(int v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v & 0xFF));
  }
  void bits(uint32_t value, int n) {  // n <= 16
    acc = (acc << n) | (value & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      const uint8_t b = static_cast<uint8_t>(acc >> nbits);
      byte(b);
      if (b == 0xFF) byte(0);
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {  // the partial last byte filled with ones
    if (nbits) bits(0x7F, 8 - nbits);
  }
};

void write_dht(Writer& w, int klass, int id, const uint8_t* bits, const uint8_t* values) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + n);
  w.byte(static_cast<uint8_t>((klass << 4) | id));
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < n; ++i) w.byte(values[i]);
}

// jfdctint.c's jpeg_fdct_islow on 16-bit elements (libjpeg-turbo's DCTELEM
// with SIMD; every value fits): output scaled by 8.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
               FIX_0_899976223 = 7373, FIX_1_175875602 = 9633, FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
               FIX_1_961570560 = 16069, FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

void fdct_islow(int16_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;     // along a row, then along a column
    const int stride = pass == 0 ? 8 : 1;  // to the next row / column
    for (int ctr = 0; ctr < 8; ++ctr) {
      int16_t* d = data + ctr * stride;
      const long tmp0 = d[0 * step] + d[7 * step];
      const long tmp7 = d[0 * step] - d[7 * step];
      const long tmp1 = d[1 * step] + d[6 * step];
      const long tmp6 = d[1 * step] - d[6 * step];
      const long tmp2 = d[2 * step] + d[5 * step];
      const long tmp5 = d[2 * step] - d[5 * step];
      const long tmp3 = d[3 * step] + d[4 * step];
      const long tmp4 = d[3 * step] - d[4 * step];

      const long tmp10 = tmp0 + tmp3;
      const long tmp13 = tmp0 - tmp3;
      const long tmp11 = tmp1 + tmp2;
      const long tmp12 = tmp1 - tmp2;
      const int shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        d[0 * step] = static_cast<int16_t>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * step] = static_cast<int16_t>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0 * step] = static_cast<int16_t>(descale(tmp10 + tmp11, kPass1Bits));
        d[4 * step] = static_cast<int16_t>(descale(tmp10 - tmp11, kPass1Bits));
      }
      long z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = static_cast<int16_t>(descale(z1 + tmp13 * FIX_0_765366865, shift));
      d[6 * step] = static_cast<int16_t>(descale(z1 + tmp12 * -FIX_1_847759065, shift));

      z1 = tmp4 + tmp7;
      long z2 = tmp5 + tmp6;
      long z3 = tmp4 + tmp6;
      long z4 = tmp5 + tmp7;
      const long z5 = (z3 + z4) * FIX_1_175875602;
      const long t4 = tmp4 * FIX_0_298631336;
      const long t5 = tmp5 * FIX_2_053119869;
      const long t6 = tmp6 * FIX_3_072711026;
      const long t7 = tmp7 * FIX_1_501321110;
      z1 = z1 * -FIX_0_899976223;
      z2 = z2 * -FIX_2_562915447;
      z3 = z3 * -FIX_1_961570560;
      z4 = z4 * -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      d[7 * step] = static_cast<int16_t>(descale(t4 + z1 + z3, shift));
      d[5 * step] = static_cast<int16_t>(descale(t5 + z2 + z4, shift));
      d[3 * step] = static_cast<int16_t>(descale(t6 + z2 + z3, shift));
      d[1 * step] = static_cast<int16_t>(descale(t7 + z1 + z4, shift));
    }
  }
}

// jcdctmgr.c's compute_reciprocal for 16-bit elements: quantising t by the
// divisor d is ((|t| + corr) * recip) >> shift, the sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

int floor_log2(uint32_t v) {
  int b = -1;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

Divisor reciprocal(uint32_t divisor) {
  const int b = floor_log2(divisor);
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((1ull << r) / divisor);
  const uint32_t fr = static_cast<uint32_t>((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

void quantize(const int16_t* ws, const Divisor* div, int16_t* coef) {
  for (int i = 0; i < 64; ++i) {
    const int t = ws[i];
    const uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
    const int q = static_cast<int>(((a + div[i].corr) * div[i].recip) >> div[i].shift);
    coef[i] = static_cast<int16_t>(t < 0 ? -q : q);
  }
}

// One component's samples: rows x cols, padded as the pre-processor pads them.
struct Plane {
  int rows, cols;
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[static_cast<size_t>(y) * cols + x]; }
};

void encode_block(Writer& w, const int16_t* coef, int& last_dc, const HuffTable& dc, const HuffTable& ac) {
  int temp = coef[0] - last_dc;
  last_dc = coef[0];
  int temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  w.bits(dc.code[nbits], dc.size[nbits]);
  if (nbits) w.bits(static_cast<uint32_t>(temp2), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = coef[kNatural[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int sym = (run << 4) + nbits;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(static_cast<uint32_t>(temp2), nbits);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// Encode a BGR HWC uint8 image (height x width, rows contiguous) as a
// baseline 4:2:0 JPEG of the given quality (1..100) into out[0 .. capacity).
// Returns the number of bytes written, or -(bytes needed) when capacity is
// too small, or 0 for an empty image.
long jpeg_encode_bgr(const uint8_t* img, int height, int width, int quality, uint8_t* out, long capacity) {
  if (height < 1 || width < 1 || height > 65535 || width > 65535) return 0;
  // jpeg_set_quality: the percentage scale, then force_baseline's clamp
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qtab[2][64];
  for (int i = 0; i < 64; ++i) {
    const int* basic[2] = {kLumaQuant, kChromaQuant};
    for (int t = 0; t < 2; ++t) {
      long v = (basic[t][i] * scale + 50L) / 100L;
      if (v <= 0) v = 1;
      if (v > 255) v = 255;
      qtab[t][i] = static_cast<int>(v);
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<uint32_t>(qtab[t][i]) << 3);

  // jccolor.c's tables
  constexpr int kScaleBits = 16;
  constexpr long kOneHalf = 1L << (kScaleBits - 1);
  constexpr long kCbCrOffset = 128L << kScaleBits;
  auto fix = [](double x) { return static_cast<long>(x * (1L << kScaleBits) + 0.5); };
  std::vector<long> tab(8 * 256);
  for (long i = 0; i < 256; ++i) {
    tab[i + 0 * 256] = fix(0.29900) * i;
    tab[i + 1 * 256] = fix(0.58700) * i;
    tab[i + 2 * 256] = fix(0.11400) * i + kOneHalf;
    tab[i + 3 * 256] = (-fix(0.16874)) * i;
    tab[i + 4 * 256] = (-fix(0.33126)) * i;
    tab[i + 5 * 256] = fix(0.50000) * i + kCbCrOffset + kOneHalf - 1;  // B -> Cb and R -> Cr
    tab[i + 6 * 256] = (-fix(0.41869)) * i;
    tab[i + 7 * 256] = (-fix(0.08131)) * i;
  }

  const int mcus_x = (width + 15) / 16, mcus_y = (height + 15) / 16;
  const int y_wib = (width + 7) / 8, y_hib = (height + 7) / 8;  // luma blocks across, down
  // the converted rows: every image row, an odd last row repeated, each row's
  // last pixel repeated to the chroma input width (jcsample.c expand_right_edge)
  const int conv_rows = height + (height & 1);
  const int conv_cols = mcus_x * 16;
  std::vector<uint8_t> conv(static_cast<size_t>(3) * conv_rows * conv_cols);
  for (int y = 0; y < conv_rows; ++y) {
    const uint8_t* row = img + static_cast<size_t>(y < height ? y : height - 1) * width * 3;
    for (int x = 0; x < conv_cols; ++x) {
      const uint8_t* p = row + 3 * (x < width ? x : width - 1);
      const int b = p[0], g = p[1], r = p[2];
      const size_t o = static_cast<size_t>(y) * conv_cols + x;
      conv[o] = static_cast<uint8_t>((tab[r] + tab[g + 256] + tab[b + 512]) >> kScaleBits);
      conv[o + static_cast<size_t>(conv_rows) * conv_cols] =
          static_cast<uint8_t>((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> kScaleBits);
      conv[o + static_cast<size_t>(2) * conv_rows * conv_cols] =
          static_cast<uint8_t>((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> kScaleBits);
    }
  }
  // luma: y_wib * 8 columns, rows padded to whole iMCU rows with the last row
  Plane luma{mcus_y * 16, y_wib * 8, {}};
  luma.px.resize(static_cast<size_t>(luma.rows) * luma.cols);
  for (int y = 0; y < luma.rows; ++y) {
    const int sy = y < height ? y : height - 1;
    std::memcpy(&luma.px[static_cast<size_t>(y) * luma.cols], &conv[static_cast<size_t>(sy) * conv_cols], luma.cols);
  }
  // chroma: h2v2_downsample of each row pair, then the last output row repeated
  Plane chroma[2];
  const int down_rows = conv_rows / 2;
  for (int c = 0; c < 2; ++c) {
    Plane& pl = chroma[c];
    pl.rows = mcus_y * 8;
    pl.cols = mcus_x * 8;
    pl.px.resize(static_cast<size_t>(pl.rows) * pl.cols);
    const uint8_t* src = &conv[static_cast<size_t>(c + 1) * conv_rows * conv_cols];
    for (int y = 0; y < pl.rows; ++y) {
      const int sy = y < down_rows ? y : down_rows - 1;
      const uint8_t* r0 = src + static_cast<size_t>(2 * sy) * conv_cols;
      const uint8_t* r1 = r0 + conv_cols;
      int bias = 1;
      for (int x = 0; x < pl.cols; ++x) {
        pl.px[static_cast<size_t>(y) * pl.cols + x] =
            static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  Writer w{out, capacity};
  w.word(0xFFD8);
  // APP0: JFIF 1.01, unit 0, density 1:1, no thumbnail
  w.word(0xFFE0);
  w.word(16);
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) w.byte(b);
  for (int t = 0; t < 2; ++t) {
    w.word(0xFFDB);
    w.word(67);
    w.byte(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) w.byte(static_cast<uint8_t>(qtab[t][kNatural[k]]));
  }
  w.word(0xFFC0);
  w.word(17);
  w.byte(8);
  w.word(height);
  w.word(width);
  w.byte(3);
  const uint8_t comps[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (const auto& c : comps) {
    w.byte(c[0]);
    w.byte(c[1]);
    w.byte(c[2]);
  }
  write_dht(w, 0, 0, kDcLumaBits, kDcValues);
  write_dht(w, 1, 0, kAcLumaBits, kAcLumaValues);
  write_dht(w, 0, 1, kDcChromaBits, kDcValues);
  write_dht(w, 1, 1, kAcChromaBits, kAcChromaValues);
  w.word(0xFFDA);
  w.word(12);
  w.byte(3);
  const uint8_t scan[3][2] = {{1, 0x00}, {2, 0x11}, {3, 0x11}};
  for (const auto& s : scan) {
    w.byte(s[0]);
    w.byte(s[1]);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  const HuffTable dc_luma(kDcLumaBits, kDcValues), ac_luma(kAcLumaBits, kAcLumaValues);
  const HuffTable dc_chroma(kDcChromaBits, kDcValues), ac_chroma(kAcChromaBits, kAcChromaValues);
  int last_dc[3] = {0, 0, 0};
  int16_t ws[64];
  int16_t blocks[6][64];

  auto dct_block = [&](const Plane& pl, int by, int bx, const Divisor* d, int16_t* coef) {
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) ws[i * 8 + j] = static_cast<int16_t>(pl.at(by * 8 + i, bx * 8 + j) - 128);
    fdct_islow(ws);
    quantize(ws, d, coef);
  };
  // jccoefct.c: blocks past the luma's last block column or row are dummies
  const int last_col_width = y_wib % 2 ? 1 : 2;
  const int last_row_height = y_hib % 2 ? 1 : 2;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      const int blockcnt = mx < mcus_x - 1 ? 2 : last_col_width;
      int blkn = 0;
      for (int yi = 0; yi < 2; ++yi) {
        if (my < mcus_y - 1 || yi < last_row_height) {
          for (int bi = 0; bi < blockcnt; ++bi) dct_block(luma, 2 * my + yi, 2 * mx + bi, div[0], blocks[blkn + bi]);
          for (int bi = blockcnt; bi < 2; ++bi) {
            std::memset(blocks[blkn + bi], 0, sizeof(blocks[0]));
            blocks[blkn + bi][0] = blocks[blkn + bi - 1][0];
          }
        } else {
          for (int bi = 0; bi < 2; ++bi) {
            std::memset(blocks[blkn + bi], 0, sizeof(blocks[0]));
            blocks[blkn + bi][0] = blocks[blkn - 1][0];
          }
        }
        blkn += 2;
      }
      dct_block(chroma[0], my, mx, div[1], blocks[4]);
      dct_block(chroma[1], my, mx, div[1], blocks[5]);
      for (int b = 0; b < 4; ++b) encode_block(w, blocks[b], last_dc[0], dc_luma, ac_luma);
      encode_block(w, blocks[4], last_dc[1], dc_chroma, ac_chroma);
      encode_block(w, blocks[5], last_dc[2], dc_chroma, ac_chroma);
    }
  }
  w.flush();
  w.word(0xFFD9);
  return w.overflow ? -w.pos : w.pos;
}

}  // extern "C"
