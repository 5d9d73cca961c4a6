// Per-channel BatchNorm batch statistics for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ihmr_tpu/ops/pallas_bn.py::_stats_kernel (K3,
// launched by bn_stats / batch_moments of PallasStatsBatchNorm). Python side:
// ihmr_tpu_torch/ops/bn_stats.py (the launch plan, the wrapper, the
// autograd.Function with the closed-form backward and the plain PyTorch
// version bn_stats_reference).
//
// What it computes: for an activation x of shape (B, C, S...) laid out
// contiguously (NCHW; a (rows, C) matrix is the case S = 1), the fp32 sums
// sum(x) and sum(x * x) over every axis but the channel axis. fp32 and bf16
// inputs, fp32 accumulation for both (the TPU kernel casts each block to
// fp32). The TPU kernel walks 512-row blocks in order on one core and
// accumulates into its output; blocks here run in parallel, so each block
// writes a partial and a second small kernel adds the partials of a channel
// in a fixed order. No atomics: the result has the same bits run to run.
//
// Layout: in NCHW the values of channel c form B contiguous runs of
// hw = H * W elements, run b starting at (b * C + c) * hw. The kernel reads
// them in place (no transposing copy).
//
// Bound on this card: bytes. Each element is read once and costs 3 flops
// (an add, a multiply, an add); ResNet-50 at B=64 reads 2.845 GB per
// training step through its 53 BatchNorms, 0.849 ms at 3.35 TB/s, against
// 2.1 GFLOP, 0.03 ms at 67 TFLOP/s. This first design:
//   * grid (C, slices); block 256 threads; a block sums one channel over a
//     slice of runs_per_slice consecutive runs;
//   * the block is cut into teams of `team` threads (32..256, the smallest
//     power of two covering one run, so short runs such as 7x7 keep most
//     threads busy); team t takes runs t, t + teams, ... of the slice and
//     its threads stride over the run;
//   * 16-byte vector loads (4 fp32 or 8 bf16) when hw is a multiple of the
//     vector width and the base is 16-byte aligned, scalar loads otherwise;
//   * warp shuffle, then block reduction through shared memory, in a fixed
//     order; the launch plan depends on the shape (and alignment) alone.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// one element
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return bf16_bits_to_float(static_cast<uint32_t>(__ldg(p)));
}

// one 16-byte vector, added into (s, q)
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ __forceinline__ static void add(const float* p, float& s, float& q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    s += (v.x + v.y) + (v.z + v.w);
    q += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
};

template <> struct Vec<uint16_t> {
  static constexpr int kWidth = 8;
  __device__ __forceinline__ static void add(const uint16_t* p, float& s, float& q) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float ps = 0.f, pq = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = bf16_bits_to_float(w[k] & 0xffffu);
      const float hi = __uint_as_float(w[k] & 0xffff0000u);
      ps += lo + hi;
      pq += lo * lo + hi * hi;
    }
    s += ps;
    q += pq;
  }
};

// grid (channels, slices); partial sums of channel c over slice s go to
// out_s[c * slices + s] and out_q[c * slices + s].
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ out_s, float* __restrict__ out_q,
                        int batch, int channels, long long hw, int team, int runs_per_slice) {
  const int c = blockIdx.x;
  const int slice = blockIdx.y;
  const int teams = kThreads / team;
  const int t = threadIdx.x / team;
  const int lane = threadIdx.x - t * team;
  const int b_end = min(batch, (slice + 1) * runs_per_slice);

  float s = 0.f, q = 0.f;
  for (int b = slice * runs_per_slice + t; b < b_end; b += teams) {
    const T* run = x + (static_cast<long long>(b) * channels + c) * hw;
    if (kVector) {
      // two independent 16-byte loads in flight per thread and iteration
      const long long n_vec = hw / Vec<T>::kWidth;
      long long i = lane;
      for (; i + team < n_vec; i += 2 * team) {
        Vec<T>::add(run + i * Vec<T>::kWidth, s, q);
        Vec<T>::add(run + (i + team) * Vec<T>::kWidth, s, q);
      }
      if (i < n_vec) Vec<T>::add(run + i * Vec<T>::kWidth, s, q);
    } else {
      for (long long i = lane; i < hw; i += team) {
        const float v = load1(run + i);
        s += v;
        q += v * v;
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  __shared__ float warp_s[kWarps];
  __shared__ float warp_q[kWarps];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_s[warp] = s;
    warp_q[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += warp_s[w];
      tq += warp_q[w];
    }
    const long long o = static_cast<long long>(c) * gridDim.y + slice;
    out_s[o] = ts;
    out_q[o] = tq;
  }
}

// one thread per channel: the slices' partials added in slice order
__global__ void bn_stats_combine_kernel(const float* __restrict__ part_s, const float* __restrict__ part_q,
                                        float* __restrict__ sum, float* __restrict__ sumsq,
                                        int channels, int slices) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float s = 0.f, q = 0.f;
  for (int k = 0; k < slices; ++k) {
    s += part_s[static_cast<long long>(c) * slices + k];
    q += part_q[static_cast<long long>(c) * slices + k];
  }
  sum[c] = s;
  sumsq[c] = q;
}

template <typename T>
void launch_partial(const void* x, float* out_s, float* out_q, int batch, int channels, long long hw,
                    int team, int runs_per_slice, int slices, int vector, cudaStream_t stream) {
  const dim3 grid(channels, slices);
  const T* xt = static_cast<const T*>(x);
  if (vector) {
    bn_stats_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, out_s, out_q, batch, channels, hw, team,
                                                                     runs_per_slice);
  } else {
    bn_stats_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, out_s, out_q, batch, channels, hw, team,
                                                                      runs_per_slice);
  }
}

}  // namespace

// x: (batch, channels, hw) contiguous, dtype 0 = fp32, 1 = bf16. sum, sumsq:
// (channels,) fp32 outputs. partial: 2 * channels * slices fp32 scratch when
// slices > 1 (unused otherwise). team divides 256 and is a multiple of 32;
// vector = 1 requires hw % (16 / sizeof(element)) == 0 and a 16-byte
// aligned x. Returns the cudaError_t of the launches (0 on success).
extern "C" int ihmr_bn_stats_forward(const void* x, int dtype, float* sum, float* sumsq, float* partial,
                                     int batch, int channels, long long hw, int team, int runs_per_slice,
                                     int slices, int vector, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (team < 32 || team > kThreads || kThreads % team != 0 || slices < 1 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* out_s = slices > 1 ? partial : sum;
  float* out_q = slices > 1 ? partial + static_cast<long long>(channels) * slices : sumsq;
  if (dtype == 0) {
    launch_partial<float>(x, out_s, out_q, batch, channels, hw, team, runs_per_slice, slices, vector, stream);
  } else if (dtype == 1) {
    launch_partial<uint16_t>(x, out_s, out_q, batch, channels, hw, team, runs_per_slice, slices, vector, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const int threads = 128;
  bn_stats_combine_kernel<<<(channels + threads - 1) / threads, threads, 0, stream>>>(out_s, out_q, sum, sumsq,
                                                                                       channels, slices);
  return static_cast<int>(cudaGetLastError());
}
