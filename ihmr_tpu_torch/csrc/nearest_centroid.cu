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
//
// Bound on this card: fp32 operations. 7 flops per query-centroid pair
// (3 mul + 2 add for q.c, the doubling and the subtraction): 2.14 GFLOP per
// call at B=128 (2 x 128 directions x 778 queries x 1538 centroids), about
// 0.032 ms at 67 TFLOP/s, against ~9.5 MB of inputs and outputs, 0.003 ms at
// 3.35 TB/s. This first design: one launch for all directions, one block
// per (direction, 128 queries), one thread per query; each tile of 128
// (cx, cy, cz, |c|^2) float4s is staged once in shared memory (2 KB) and
// read by all threads as a broadcast; one pass per tile keeps the minimum,
// the index sum and the count. Built with --fmad=false so the rank rounds
// exactly like the plain version's separate PyTorch ops.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kQTile = 128;  // queries per block
constexpr int kTTile = 128;  // centroids per tile
constexpr float kBig = 1e30f;

// grid (vp / 128, n); block 128 threads, one query each.
// query (n, vp, 3); cent (n, fp, 4) = (cx, cy, cz, |c|^2); index (n, vp).
__global__ void __launch_bounds__(kQTile)
nearest_centroid_kernel(const float* __restrict__ query, const float4* __restrict__ cent,
                        int* __restrict__ index, int vp, int fp, int n_tri) {
  __shared__ float4 s_cent[kTTile];

  const int n = blockIdx.y;
  const size_t qi = static_cast<size_t>(n) * vp + blockIdx.x * kQTile + threadIdx.x;
  const float qx = query[qi * 3 + 0];
  const float qy = query[qi * 3 + 1];
  const float qz = query[qi * 3 + 2];
  const float4* cent_n = cent + static_cast<size_t>(n) * fp;
  const int n_tiles = fp / kTTile;

  float best = kBig;
  float best_idx = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile's reads finish before this tile's writes
    s_cent[threadIdx.x] = cent_n[t * kTTile + threadIdx.x];
    __syncthreads();

    const int valid = min(kTTile, n_tri - t * kTTile);
    float tmin = kBig, sum = 0.f, cnt = 0.f;
    for (int k = 0; k < valid; ++k) {
      const float4 c = s_cent[k];
      const float rank = c.w - 2.f * ((c.x * qx + c.y * qy) + c.z * qz);
      const float id = static_cast<float>(t * kTTile + k);
      if (rank < tmin) {
        tmin = rank;
        sum = id;
        cnt = 1.f;
      } else if (rank == tmin) {
        sum += id;
        cnt += 1.f;
      }
    }
    if (tmin < best) {
      best = tmin;
      best_idx = sum / fmaxf(cnt, 1.f);
    }
  }
  index[qi] = static_cast<int>(best_idx);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ihmr_nearest_centroid_forward(const float* query, const float* cent, int* index,
                                             int n, int vp, int fp, int n_tri, void* stream) {
  if (n <= 0 || vp <= 0 || fp <= 0 || vp % kQTile || fp % kTTile || n_tri <= 0 || n_tri > fp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(vp / kQTile, n);
  nearest_centroid_kernel<<<grid, kQTile, 0, static_cast<cudaStream_t>(stream)>>>(
      query, reinterpret_cast<const float4*>(cent), index, vp, fp, n_tri);
  return static_cast<int>(cudaGetLastError());
}
