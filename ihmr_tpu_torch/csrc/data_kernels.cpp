// Host-side data kernels of ihmr_tpu_torch (C, loaded with ctypes by
// ihmr_tpu_torch/data/native.py; built with g++ by ihmr_tpu_torch/build.py).
//
// letterbox_normalize{,_batch} and normalize_batch are a copy of the JAX
// package's ihmr_tpu/native/data_kernels.cpp with the same arithmetic, so the
// same compiler and flags give the same bits: a top-left anchored letterbox
// (float bilinear, zero padding) fused with the uint8 -> [-1, 1] float32
// normalization, channel order preserved (the reference feeds cv2's BGR
// straight through ToTensor).
//
// png_unfilter undoes the five PNG row filters (None, Sub, Up, Average,
// Paeth) of a decompressed 8-bit image. Average and Paeth depend on the
// pixel just decoded, so they run one byte after another.
//
// resize_linear_u8 runs the integer passes of OpenCV's INTER_LINEAR resize
// of a uint8 image with taps and 11-bit weights computed by the caller
// (ihmr_tpu_torch/data/image_io.py::resize_linear).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear sample of a uint8 HWC image at (x, y) for channel c.
inline float bilinear(const uint8_t* img, int h, int w, int channels, float y,
                      float x, int c) {
  int x0 = static_cast<int>(x);
  int y0 = static_cast<int>(y);
  int x1 = std::min(x0 + 1, w - 1);
  int y1 = std::min(y0 + 1, h - 1);
  float fx = x - x0;
  float fy = y - y0;
  const float v00 = img[(y0 * w + x0) * channels + c];
  const float v01 = img[(y0 * w + x1) * channels + c];
  const float v10 = img[(y1 * w + x0) * channels + c];
  const float v11 = img[(y1 * w + x1) * channels + c];
  return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
         v10 * fy * (1 - fx) + v11 * fy * fx;
}

template <typename Fn>
void parallel_for(int n, Fn&& fn) {
  int workers = std::min<int>(n, std::max(1u, std::thread::hardware_concurrency()));
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

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Letterbox one uint8 HWC image into a final_size x final_size canvas
// (top-left anchored, padding -1 after normalization) and emit normalized
// float32 in [-1, 1], channel order preserved. Returns the resize ratio
// applied to pixel coordinates.
float letterbox_normalize(const uint8_t* img, int h, int w, int channels,
                          int final_size, float* out /* S*S*3 */) {
  float ratio;
  int new_h, new_w;
  if (h > w) {
    ratio = static_cast<float>(final_size) / h;
    new_h = final_size;
    new_w = static_cast<int>(ratio * w);
  } else {
    ratio = static_cast<float>(final_size) / w;
    new_w = final_size;
    new_h = static_cast<int>(ratio * h);
  }
  // normalized zero-pixel value is (0/255 - .5)/.5 = -1
  for (int i = 0; i < final_size * final_size * 3; ++i) out[i] = -1.0f;

  const float sx = static_cast<float>(w) / new_w;
  const float sy = static_cast<float>(h) / new_h;
  for (int y = 0; y < new_h; ++y) {
    const float src_y = std::min((y + 0.5f) * sy - 0.5f, h - 1.0f);
    const float cy = src_y < 0 ? 0 : src_y;
    for (int x = 0; x < new_w; ++x) {
      const float src_x = std::min((x + 0.5f) * sx - 0.5f, w - 1.0f);
      const float cx = src_x < 0 ? 0 : src_x;
      float* dst = out + (y * final_size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = bilinear(img, h, w, channels, cy, cx, c);
        dst[c] = (v / 255.0f - 0.5f) / 0.5f;
      }
    }
  }
  return ratio;
}

// Batched variant over images with identical input dims.
void letterbox_normalize_batch(const uint8_t* imgs, int batch, int h, int w,
                               int channels, int final_size, float* out,
                               float* ratios) {
  const size_t in_stride = static_cast<size_t>(h) * w * channels;
  const size_t out_stride = static_cast<size_t>(final_size) * final_size * 3;
  parallel_for(batch, [&](int i) {
    ratios[i] = letterbox_normalize(imgs + i * in_stride, h, w, channels,
                                    final_size, out + i * out_stride);
  });
}

// Batched uint8 HWC -> normalized float32 HWC (no resize), channel order
// preserved.
void normalize_batch(const uint8_t* imgs, int batch, int h, int w, float* out) {
  const size_t stride = static_cast<size_t>(h) * w * 3;
  parallel_for(batch, [&](int i) {
    const uint8_t* src = imgs + i * stride;
    float* dst = out + i * stride;
    for (size_t p = 0; p < stride; ++p) {
      dst[p] = (src[p] / 255.0f - 0.5f) / 0.5f;
    }
  });
}

// Undo the PNG row filters. ``data`` holds ``height`` rows of one filter-type
// byte followed by ``row_bytes`` filtered bytes; ``bpp`` is the bytes per
// pixel (the filters' left neighbour distance). Writes height * row_bytes
// bytes to ``out``. Returns 0, or 1 + the row index of an unknown filter type.
int png_unfilter(const uint8_t* data, int height, int row_bytes, int bpp,
                 uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = data + static_cast<size_t>(y) * (row_bytes + 1);
    const int type = src[0];
    ++src;
    uint8_t* cur = out + static_cast<size_t>(y) * row_bytes;
    const uint8_t* prev = y > 0 ? cur - row_bytes : nullptr;
    switch (type) {
      case 0:  // None
        std::memcpy(cur, src, row_bytes);
        break;
      case 1:  // Sub
        for (int i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// Horizontal pass S = src[sx] * a0 + src[sx + 1] * a1 (int32, the next
// index clamped) for every source row that a destination row reads, then the
// vertical pass of OpenCV's vector code,
// (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2, saturated.
// xofs / a0 / a1 have w entries, yofs / b0 / b1 have h (yofs may be -1 or
// past the last row: rows are clamped).
void resize_linear_u8(const uint8_t* src, int H, int W, int C, uint8_t* dst,
                      int h, int w, const int* xofs, const int* a0,
                      const int* a1, const int* yofs, const int* b0,
                      const int* b1) {
  const int row = w * C;
  std::vector<int> rows(static_cast<size_t>(H) * row);
  std::vector<char> done(H, 0);
  auto hrow = [&](int y) -> const int* {
    y = std::min(std::max(y, 0), H - 1);
    int* out = rows.data() + static_cast<size_t>(y) * row;
    if (!done[y]) {
      const uint8_t* s = src + static_cast<size_t>(y) * W * C;
      for (int x = 0; x < w; ++x) {
        const int x0 = xofs[x], x1 = std::min(x0 + 1, W - 1);
        for (int c = 0; c < C; ++c)
          out[x * C + c] = s[x0 * C + c] * a0[x] + s[x1 * C + c] * a1[x];
      }
      done[y] = 1;
    }
    return out;
  };
  for (int y = 0; y < h; ++y) {
    const int* s0 = hrow(yofs[y]);
    const int* s1 = hrow(yofs[y] + 1);
    uint8_t* d = dst + static_cast<size_t>(y) * row;
    for (int i = 0; i < row; ++i) {
      const int v = (((b0[y] * (s0[i] >> 4)) >> 16) + ((b1[y] * (s1[i] >> 4)) >> 16) + 2) >> 2;
      d[i] = static_cast<uint8_t>(std::min(std::max(v, 0), 255));
    }
  }
}

}  // extern "C"
