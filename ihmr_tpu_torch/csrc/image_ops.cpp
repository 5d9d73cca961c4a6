// OpenCV's image operations that the training augmentations use, as the
// port's own host code (C, loaded with ctypes by
// ihmr_tpu_torch/data/cv_ops.py; built with g++ by ihmr_tpu_torch/build.py
// with -ffp-contract=off: every fused multiply-add below is an explicit
// fmaf, so the bytes do not depend on the host's instruction set).
//
// warp_affine_linear_u8: cv2.warpAffine, INTER_LINEAR, constant border 0,
// given the inverse map. OpenCV 5 computes it in float32: per row
// Mx = y * M1 + M2 (no fusion); in blocks of 16 columns the source
// coordinate is fma(M0, x, Mx), in the columns after the last whole block
// fma(x, M0, y * M1) + M2; the weights are the coordinate's fractional part,
// the interpolation three fmas (x, then y) and the result rounds half to even.
//
// bgr_to_hsv_u8: cv2.COLOR_BGR2HSV on uint8, OpenCV's integer path
// (hsv_shift 12, divisions by table).
//
// hsv_to_bgr_u8: cv2.COLOR_HSV2BGR on uint8. OpenCV 5 converts each row in
// blocks of 32 pixels with its vector code, which fuses 1 - s * h and
// truncates the scaled result, and converts the rest of the row with its
// scalar code, which fuses the same products and rounds half to even.
//
// filter2d_u8: cv2.filter2D(img, -1, kernel): correlation, anchor at the
// kernel's centre, BORDER_REFLECT_101, float32 sums over the non-zero taps
// in row-major order, rounded half to even and saturated. Each output row's
// sums are independent lanes along x (vectorised by the compiler); rows are
// split over threads when the image is large enough to pay for them.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Below this many multiply-adds a call runs on the calling thread: starting
// threads costs more than a 224x224 image's work, and the caller is a data
// thread that shares the host with the one dispatching to the card.
constexpr double kThreadedWork = 3.2e7;

// fn(0) .. fn(n - 1), over threads when the call's work is at least kThreadedWork
template <typename Fn>
void parallel_for(int n, double work, Fn&& fn) {
  int workers = work < kThreadedWork ? 1 : std::min<int>(n, std::max(1u, std::thread::hardware_concurrency()));
  if (workers <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

inline uint8_t saturate_round(float v) {
  long r = std::lrintf(v);  // the default rounding mode: half to even
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

constexpr int kWarpBlock = 16;  // OpenCV 5's vector block of warpAffine (float32 x 8, unrolled twice)
constexpr int kHsvBlock = 32;   // and of the HSV -> BGR conversion (4 vectors of 8)

}  // namespace

extern "C" {

// src (h, w, c) uint8 -> dst (dh, dw, c); m is the inverse map (dst -> src)
// as doubles, rounded to float32 here as OpenCV does.
void warp_affine_linear_u8(const uint8_t* src, int h, int w, int c, const double* m, uint8_t* dst, int dh,
                           int dw) {
  float M[6];
  for (int i = 0; i < 6; ++i) M[i] = static_cast<float>(m[i]);
  const int vend = dw / kWarpBlock * kWarpBlock;
  parallel_for(dh, 12.0 * dh * dw * c, [&](int y) {
    const float fy = static_cast<float>(y);
    const float mx = fy * M[1] + M[2];
    const float my = fy * M[4] + M[5];
    uint8_t* out = dst + static_cast<long>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < vend) {
        sx = std::fmaf(M[0], fx, mx);
        sy = std::fmaf(M[3], fx, my);
      } else {
        sx = std::fmaf(fx, M[0], fy * M[1]) + M[2];
        sy = std::fmaf(fx, M[3], fy * M[4]) + M[5];
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const float a = sx - flx, b = sy - fly;
      const long ix = static_cast<long>(flx), iy = static_cast<long>(fly);
      const uint8_t* tap[2][2];  // each neighbour's first channel, or null outside the source
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          const long yy = iy + dy, xx = ix + dx;
          tap[dy][dx] = (yy < 0 || xx < 0 || yy >= h || xx >= w) ? nullptr : src + (yy * w + xx) * c;
        }
      }
      for (int ch = 0; ch < c; ++ch) {
        float p[2][2];
        for (int dy = 0; dy < 2; ++dy)
          for (int dx = 0; dx < 2; ++dx) p[dy][dx] = tap[dy][dx] ? static_cast<float>(tap[dy][dx][ch]) : 0.f;
        const float f0 = std::fmaf(a, p[0][1] - p[0][0], p[0][0]);
        const float f1 = std::fmaf(a, p[1][1] - p[1][0], p[1][0]);
        out[static_cast<long>(x) * c + ch] = saturate_round(std::fmaf(b, f1 - f0, f0));
      }
    }
  });
}

void bgr_to_hsv_u8(const uint8_t* src, long n, uint8_t* dst) {
  constexpr int shift = 12;
  int sdiv[256], hdiv[256];
  sdiv[0] = hdiv[0] = 0;
  for (int i = 1; i < 256; ++i) {
    sdiv[i] = static_cast<int>(std::lrint((255 << shift) / (1.0 * i)));
    hdiv[i] = static_cast<int>(std::lrint((180 << shift) / (6.0 * i)));
  }
  for (long i = 0; i < n; ++i) {
    const int b = src[3 * i], g = src[3 * i + 1], r = src[3 * i + 2];
    const int v = std::max(b, std::max(g, r));
    const int vmin = std::min(b, std::min(g, r));
    const int diff = v - vmin;
    const int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
    const int s = (diff * sdiv[v] + (1 << (shift - 1))) >> shift;
    int hh = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + ((~vg) & (r - g + 4 * diff))));
    hh = (hh * hdiv[diff] + (1 << (shift - 1))) >> shift;
    hh += hh < 0 ? 180 : 0;
    dst[3 * i] = static_cast<uint8_t>(hh);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

void hsv_to_bgr_u8(const uint8_t* src, int rows, int cols, uint8_t* dst) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  // the sector and its fraction depend on the hue byte alone
  int sectors[256];
  float fractions[256];
  const float hscale = 6.f / 180.f;
  for (int i = 0; i < 256; ++i) {
    float h = std::fmod(i * hscale, 6.f);
    int sector = static_cast<int>(std::floor(h));
    h -= static_cast<float>(sector);
    if (static_cast<unsigned>(sector) >= 6u) {
      sector = 0;
      h = 0.f;
    }
    sectors[i] = sector;
    fractions[i] = h;
  }
  const int vend = cols / kHsvBlock * kHsvBlock;
  for (int y = 0; y < rows; ++y) {
    for (int x = 0; x < cols; ++x) {
      const long i = static_cast<long>(y) * cols + x;
      const float s = src[3 * i + 1] * (1.f / 255.f), v = src[3 * i + 2] * (1.f / 255.f);
      const int sector = sectors[src[3 * i]];
      const float h = fractions[src[3 * i]];
      const float tab[4] = {v, v * (1.f - s), v * std::fmaf(-s, h, 1.f), v * std::fmaf(-s, 1.f - h, 1.f)};
      for (int ch = 0; ch < 3; ++ch) {
        const float o = tab[sector_data[sector][ch]] * 255.f;
        if (x < vend) {
          const long t = static_cast<long>(o);  // the vector block truncates
          dst[3 * i + ch] = static_cast<uint8_t>(t < 0 ? 0 : (t > 255 ? 255 : t));
        } else {
          dst[3 * i + ch] = saturate_round(o);
        }
      }
    }
  }
}

// src (h, w, c) uint8, kernel (kh, kw) float32 -> dst (h, w, c) uint8.
void filter2d_u8(const uint8_t* src, int h, int w, int c, const float* kernel, int kh, int kw, uint8_t* dst) {
  const int ay = kh / 2, ax = kw / 2;
  std::vector<int> tap_y, tap_x;
  std::vector<float> tap_w;
  for (int i = 0; i < kh; ++i) {
    for (int j = 0; j < kw; ++j) {
      if (kernel[i * kw + j] != 0.f) {  // a zero tap adds +0 to every sum
        tap_y.push_back(i);
        tap_x.push_back(j);
        tap_w.push_back(kernel[i * kw + j]);
      }
    }
  }
  // the image as float32 with the reflected border, (h + kh - 1, w + kw - 1, c)
  const int ph = h + kh - 1, pw = w + kw - 1;
  const long prow = static_cast<long>(pw) * c;
  std::vector<float> pad(static_cast<size_t>(ph) * prow);
  std::vector<int> col(pw);
  for (int x = 0; x < pw; ++x) col[x] = reflect101(x - ax, w);
  parallel_for(ph, static_cast<double>(ph) * pw * c, [&](int y) {
    const uint8_t* row = src + static_cast<long>(reflect101(y - ay, h)) * w * c;
    float* out = pad.data() + y * prow;
    for (int x = 0; x < pw; ++x)
      for (int ch = 0; ch < c; ++ch) out[static_cast<long>(x) * c + ch] = row[static_cast<long>(col[x]) * c + ch];
  });
  const long n = static_cast<long>(w) * c;
  const int taps = static_cast<int>(tap_w.size());
  parallel_for(h, static_cast<double>(h) * n * taps, [&](int y) {
    std::vector<float> acc(n, 0.f);
    float* a = acc.data();
    for (int t = 0; t < taps; ++t) {
      const float k = tap_w[t];
      const float* p = pad.data() + (y + tap_y[t]) * prow + static_cast<long>(tap_x[t]) * c;
      for (long i = 0; i < n; ++i) a[i] = a[i] + k * p[i];
    }
    uint8_t* out = dst + static_cast<long>(y) * n;
    for (long i = 0; i < n; ++i) out[i] = saturate_round(a[i]);
  });
}

}  // extern "C"
