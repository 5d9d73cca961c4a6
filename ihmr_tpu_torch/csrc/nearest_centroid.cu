// Streaming nearest-centroid selection for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ihmr_tpu/ops/pallas_collision.py::_nearest_kernel
// (K2, launched by nearest_centroid_pallas). Python side:
// ihmr_tpu_torch/ops/nearest_centroid.py (padding, centroids and |c|^2, the
// launch wrapper and the plain PyTorch version nearest_centroid_reference,
// which this kernel must match index for index).
//
// What it computes, per direction n and query q: the index of the triangle
// centroid c minimising rank = |c|^2 - 2 q.c (|q|^2 is the same for every
// centroid of one query), in fp32, with the TPU kernel's tie rules:
//   * centroids are walked in 128-wide tiles, in order;
//   * within a tile: the minimum rank, and the mean of the indices of every
//     centroid with rank <= tile minimum (fp32 sum / count);
//   * across tiles: only tile_min < best replaces the best;
//   * the result is that fp32 mean truncated to int, as astype(int32) does;
//   * inputs arrive padded: queries by repeating query 0, centroids by
//     repeating centroid 0; indices >= n_tri are masked here.
// The tile minima decide which tile wins; its tie set is needed only once.
// So the kernel keeps, per tile, the minimum alone, and at the end walks the
// winning tile again for the sum and count of the indices whose rank equals
// its minimum. The indices are integers below 2^24, so their fp32 sums are
// exact in any order and the mean rounds as the plain version's.
//
// Bound on this card: fp32 operations. 7 flops per query-centroid pair
// (3 mul + 2 add for q.c, the doubling and the subtraction from |c|^2),
// issued one by one under --fmad=false (kept: the rank must round like the
// plain version's separate PyTorch ops); the inputs and outputs are ~9.5 MB.
// The design keeps the other instructions per pair few:
//   * each thread takes kQPT queries, so one shared-memory float4 read of a
//     centroid serves all of them;
//   * a block stages up to kChunk centroids of its direction at once (the
//     whole 1538 of a MANO hand: 24.6 KB), so there is no barrier per tile;
//   * per pair only the rank and one minimum: compares and selects run on
//     the SM's half-rate integer pipe, so tie bookkeeping per pair (compare,
//     branch, index conversion) would cost more than the rank itself; the
//     tie sums are a second walk over one tile per query (1/12 of the work
//     at a MANO hand's 1538 centroids).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTTile = 128;   // centroids per tile (the tie rule's unit)
constexpr int kThreads = 128;  // threads per block
constexpr int kQPT = 4;        // queries per thread
constexpr int kQBlock = kThreads * kQPT;
constexpr int kChunk = 2048;   // centroids staged at once (32 KB)
constexpr float kBig = 1e30f;

// rank = |c|^2 - 2 q.c, each operation rounded as in the plain version
__device__ __forceinline__ float rank(const float4& c, float qx, float qy, float qz) {
  return c.w - 2.f * ((c.x * qx + c.y * qy) + c.z * qz);
}

// grid (ceil(vp / kQBlock), n); block kThreads threads, queries
// blockIdx.x * kQBlock + threadIdx.x * kQPT + j of direction n.
// query (n, vp, 3); cent (n, fp, 4) = (cx, cy, cz, |c|^2); index (n, vp).
__global__ void __launch_bounds__(kThreads)
nearest_centroid_kernel(const float* __restrict__ query, const float4* __restrict__ cent,
                        int* __restrict__ index, int vp, int fp, int n_tri) {
  extern __shared__ float4 s_cent[];  // min(n_tri, kChunk) centroids

  const int n = blockIdx.y;
  const int first = blockIdx.x * kQBlock + threadIdx.x * kQPT;
  const bool active = first < vp;  // vp is a multiple of 128, so all kQPT queries are real
  const size_t q0 = static_cast<size_t>(n) * vp + (active ? first : 0);
  const float4* cent_n = cent + static_cast<size_t>(n) * fp;

  float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
  int best_tile[kQPT];  // the first tile whose minimum is best
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    qx[j] = query[(q0 + j) * 3 + 0];
    qy[j] = query[(q0 + j) * 3 + 1];
    qz[j] = query[(q0 + j) * 3 + 2];
    best[j] = kBig;
    best_tile[j] = 0;
  }

  int c0 = 0;  // the first centroid in shared memory
  for (; c0 < n_tri; c0 += kChunk) {
    const int m = min(kChunk, n_tri - c0);
    __syncthreads();  // the previous chunk's reads finish before this chunk's writes
    for (int i = threadIdx.x; i < m; i += kThreads) s_cent[i] = cent_n[c0 + i];
    __syncthreads();
    if (!active) continue;
    for (int t0 = 0; t0 < m; t0 += kTTile) {
      // per pair: the rank and a minimum, nothing else
      float tmin[kQPT];
#pragma unroll
      for (int j = 0; j < kQPT; ++j) tmin[j] = kBig;
      const int end = min(t0 + kTTile, m);
#pragma unroll 4
      for (int k = t0; k < end; ++k) {
        const float4 c = s_cent[k];
#pragma unroll
        for (int j = 0; j < kQPT; ++j) tmin[j] = fminf(tmin[j], rank(c, qx[j], qy[j], qz[j]));
      }
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        if (tmin[j] < best[j]) {
          best[j] = tmin[j];
          best_tile[j] = (c0 + t0) / kTTile;
        }
      }
    }
  }
  c0 -= kChunk;

  if (active) {
    // the tie rule on the winning tile: the mean index of the ranks equal to
    // its minimum. The indices are exact in fp32, so their order does not
    // matter: each lane starts at its own offset to spread shared-memory banks.
    int out[kQPT];
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
      const int t0 = best_tile[j] * kTTile;
      const int count = min(kTTile, n_tri - t0);
      const int off = static_cast<int>(threadIdx.x) % count;
      float sum = 0.f, cnt = 0.f;
      auto walk = [&](const float4* src) {  // src[k] is centroid k
        for (int i = 0; i < count; ++i) {
          int k = t0 + off + i;
          if (k >= t0 + count) k -= count;
          if (rank(src[k], qx[j], qy[j], qz[j]) == best[j]) {
            sum += static_cast<float>(k);
            cnt += 1.f;
          }
        }
      };
      if (t0 >= c0) {
        walk(s_cent - c0);  // the tile is in the chunk staged last
      } else {
        walk(cent_n);
      }
      out[j] = static_cast<int>(sum / fmaxf(cnt, 1.f));
    }
    reinterpret_cast<int4*>(index)[q0 / kQPT] = make_int4(out[0], out[1], out[2], out[3]);
  }
}
static_assert(kQPT == 4, "the index store writes one int4 per thread");

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ihmr_nearest_centroid_forward(const float* query, const float* cent, int* index,
                                             int n, int vp, int fp, int n_tri, void* stream) {
  if (n <= 0 || vp <= 0 || fp <= 0 || vp % kTTile || fp % kTTile || n_tri <= 0 || n_tri > fp ||
      reinterpret_cast<uintptr_t>(cent) % 16 || reinterpret_cast<uintptr_t>(index) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((vp + kQBlock - 1) / kQBlock, n);
  nearest_centroid_kernel<<<grid, kThreads, min(n_tri, kChunk) * sizeof(float4),
                            static_cast<cudaStream_t>(stream)>>>(
      query, reinterpret_cast<const float4*>(cent), index, vp, fp, n_tri);
  return static_cast<int>(cudaGetLastError());
}
