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
// fp32). No float atomics: the sums are taken in an order fixed by the
// shape, the dtype and the alignment, so a second launch gives the same bits.
//
// Bound on this card: bytes. Each element is read once and costs 3 flops;
// one ResNet-50 training step at B=64 reads 2.845 GB through its 53
// BatchNorms in fp32 (0.849 ms at 3.35 TB/s) and 1.42 GB in bf16 (0.425 ms),
// against 2.1 GFLOP (0.03 ms at 67 TFLOP/s).
//
// What the first design (PR 3) lost, measured on an H100 at 700 W: 1.6207 ms
// a step in fp32 (52% of the bound) and 1.2534 ms in bf16 (34%):
//   * two launches per BatchNorm (a partial kernel, then a combine kernel)
//     for every C <= 512: 95 device kernels a step, where 28 of the bf16
//     shapes have a bytes bound of 1-4 us;
//   * 16-byte loads only when a run (one channel of one sample, hw
//     elements) is a whole number of vectors: 7x7 in fp32 and 7x7 and 14x14
//     in bf16 (28 of 53 BatchNorms) read 2 or 4 bytes a load;
//   * runs of 98-196 bytes read one team of threads each, with 49 of 64 or
//     98 of 128 threads working;
//   * at most two 16-byte loads in flight per thread; C = 2048 launched 2048
//     blocks, two waves on 132 SMs.
//
// This design: one launch, a grid of at most one wave of resident blocks
// (132 SMs x kMinBlocks), each block walking its work items (blockIdx.x,
// then gridDim.x apart), 16-byte loads at every shape of the step, and
// kLoads loads in flight per thread. Two paths, chosen per shape by
// launch_plan (measured against the first design on an H100 at 700 W by
// compare_kernels --bn: 1.2778 / 1.2993 ms a step in fp32, 0.7879 / 0.7906
// ms in bf16, every shape faster):
//   * runs (runs of more than 1 KB that are a whole number of vectors:
//     28x28 and up): an item is one channel over a slice of samples; its
//     rows x (hw / width) vectors are numbered as one range, so every thread
//     loads whatever the run length; two rounds of kLoads / 2 loads are in
//     flight (the next round is issued before the current one is added).
//     The batch is cut into slices so that channels x slices fills the wave;
//     an item whose channel spans several slices writes its partial sums to
//     scratch, makes them visible (__threadfence) and takes a ticket from
//     the channel's counter; the block that takes the last ticket adds the
//     slices' partials (lanes over the slices, a shuffle tree), writes the
//     sums and resets the counter to 0 for the next launch (the wrapper
//     allocates the counters zeroed once per device);
//   * tiles (7x7 and 14x14): for one sample, ct consecutive channels are one
//     contiguous span of ct * hw elements, and an item is such a group over
//     the whole batch, so nothing leaves the block but the sums (no partials,
//     no ticket: the fixed cost of a small BatchNorm is one launch and one
//     pass). Thread t owns one 16-byte slot of the span in every sample of
//     its row group, adds sample after sample into per-lane accumulators in
//     registers, and never needs to know which channel a column belongs to
//     until the end: then the row groups' columns are added in shared memory
//     and one warp per channel adds that channel's hw columns in a fixed
//     order. ct is a multiple of 16 / gcd(hw * element size, 16), so every
//     span starts 16-byte aligned and is a whole number of vectors (7x7
//     included), and the smallest such multiple that leaves at most one wave
//     of groups. The ragged tail of C is a shorter last group; an activation
//     whose rows are not a whole number of vectors or whose base is not
//     16-byte aligned takes the same walk with masked scalar loads.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;     // resident blocks per SM (launch_plan's BLOCKS_PER_SM): 64 registers a thread
constexpr int kLoads = 8;         // loads in flight a thread (runs: two rounds of kLoads / 2; tiles: kLoads samples)

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kWidth = 4;  // elements per 16-byte vector
  using Vec = float4;
  __device__ __forceinline__ static float one(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static float4 vec(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ static void unpack(const float4& a, float (&v)[4]) {
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <> struct Elem<uint16_t> {  // bf16 bits
  static constexpr int kWidth = 8;
  using Vec = uint4;
  __device__ __forceinline__ static float one(const uint16_t* p) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
  }
  __device__ __forceinline__ static uint4 vec(const uint16_t* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ static void unpack(const uint4& a, float (&v)[8]) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

// n values added into (s, q): s gets their pairwise sum, q each square fused
// into the running sum (one rounding a term)
template <int N>
__device__ __forceinline__ void add_values(const float (&v)[N], float& s, float& q) {
  float t[N];
#pragma unroll
  for (int l = 0; l < N; ++l) t[l] = v[l];
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int l = 0; l + w < N; l += 2 * w) t[l] += t[l + w];
  }
  s += t[0];
#pragma unroll
  for (int l = 0; l < N; ++l) q = __fmaf_rn(v[l], v[l], q);
}

// (s, q) summed over the block, valid in thread 0; warps in order.
__device__ __forceinline__ void block_sum(float& s, float& q, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = s;
    red[kWarps + warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0.f;
    q = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += red[w];
      q += red[kWarps + w];
    }
  }
  __syncthreads();  // red is reused by the next item
}

// Called by every thread once the item's partials are written: the block
// that takes the group's last ticket returns true (the same in all threads).
__device__ __forceinline__ bool last_ticket(int* tickets, int group, int slices, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(tickets + group, 1) == slices - 1;
    if (last) tickets[group] = 0;  // every ticket of this launch is taken
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// Runs path. Item (c, k): channel c over samples [k * rows, (k + 1) * rows).
// out: sums at [0, C), sums of squares at [C, 2C); part: 2 floats an item.
// Thread t takes loads t + m * kThreads (m < kRound) of the item's range,
// then the same kRound * kThreads further on; its kRound streams keep their
// (sample, load in the run) positions, advanced without a division. Two
// rounds are in flight: the next round's loads are issued (from a clamped
// address when past the range) before the current round is added; stream m
// adds into accumulator m % 2.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bn_stats_runs_kernel(const T* __restrict__ x, float* __restrict__ out, float* __restrict__ part,
                     int* __restrict__ tickets, int batch, int channels, long long hw, int rows, int slices) {
  constexpr int U = kVector ? Elem<T>::kWidth : 1;  // elements per load
  using Raw = typename std::conditional<kVector, typename Elem<T>::Vec, float>::type;
  constexpr int kRound = kLoads / 2;
  constexpr unsigned kStep = kRound * kThreads;
  __shared__ float red[2 * kWarps];
  __shared__ int flag;
  const unsigned units = static_cast<unsigned>(hw / U);  // loads per run
  const unsigned sb = kStep / units, su = kStep - sb * units;  // a stream's advance: samples, loads
  const long long row_stride = static_cast<long long>(channels) * hw;
  const int items = channels * slices;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / slices;
    const int k = item - c * slices;
    const int b0 = k * rows;
    const unsigned nb = static_cast<unsigned>(min(batch - b0, rows));
    const T* run0 = x + (static_cast<long long>(b0) * channels + c) * hw;
    unsigned bs[kRound], us[kRound];
#pragma unroll
    for (int m = 0; m < kRound; ++m) {
      const unsigned j = threadIdx.x + m * kThreads;
      bs[m] = j / units;
      us[m] = j - bs[m] * units;
    }
    // one round's loads into raw; returns the mask of those in the range
    auto issue = [&](Raw (&raw)[kRound]) {
      unsigned mask = 0;
#pragma unroll
      for (int m = 0; m < kRound; ++m) {
        const bool ok = bs[m] < nb;
        mask |= static_cast<unsigned>(ok) << m;
        const T* p = run0 + (ok ? bs[m] * row_stride + static_cast<long long>(us[m]) * U : 0);
        if constexpr (kVector) {
          raw[m] = Elem<T>::vec(p);
        } else {
          raw[m] = Elem<T>::one(p);
        }
        us[m] += su;
        bs[m] += sb;
        if (us[m] >= units) {
          us[m] -= units;
          ++bs[m];
        }
      }
      return mask;
    };
    float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
    Raw cur[kRound], nxt[kRound];
    unsigned cur_mask = issue(cur);
    while (cur_mask != 0) {
      const unsigned nxt_mask = issue(nxt);
#pragma unroll
      for (int m = 0; m < kRound; ++m) {
        float v[U];
        if constexpr (kVector) {
          Elem<T>::unpack(cur[m], v);
        } else {
          v[0] = cur[m];
        }
        if ((cur_mask >> m) & 1u) add_values(v, s[m & 1], q[m & 1]);
        cur[m] = nxt[m];
      }
      cur_mask = nxt_mask;
    }
    float ts = s[0] + s[1];
    float tq = q[0] + q[1];
    block_sum(ts, tq, red);
    if (slices == 1) {
      if (threadIdx.x == 0) {
        out[c] = ts;
        out[channels + c] = tq;
      }
      continue;
    }
    if (threadIdx.x == 0) {
      part[2 * static_cast<long long>(item)] = ts;
      part[2 * static_cast<long long>(item) + 1] = tq;
    }
    if (last_ticket(tickets, c, slices, &flag) && threadIdx.x < 32) {
      // warp 0 adds the slices' partials: lane l takes slices l, l + 32, ...
      // in order, then a fixed shuffle tree
      const float* pc = part + 2 * static_cast<long long>(c) * slices;
      float as = 0.f, aq = 0.f;
      for (int kk = threadIdx.x; kk < slices; kk += 32) {
        as += __ldcg(pc + 2 * kk);
        aq += __ldcg(pc + 2 * kk + 1);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        as += __shfl_down_sync(0xffffffffu, as, off);
        aq += __shfl_down_sync(0xffffffffu, aq, off);
      }
      if (threadIdx.x == 0) {
        out[c] = as;
        out[channels + c] = aq;
      }
    }
    __syncthreads();  // flag is reused by the next item
  }
}

// Tiles path. Block item g: channels [g * ct, g * ct + nch) over the whole
// batch, so no partials leave the block. The group's span in a sample is
// slots 16-byte vectors (ct * hw <= kThreads * W elements); thread t owns
// vector slot t % slots in samples t / slots, t / slots + groups_r, ... (the
// block's groups_r = kThreads / slots row groups), with kLoads samples loaded
// before any is added, into per-lane accumulators. Then the row groups'
// columns are added in shared memory in row-group order, and one warp per
// channel adds that channel's hw columns (lane-strided, a shuffle tree).
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bn_stats_tiles_kernel(const T* __restrict__ x, float* __restrict__ out, int batch, int channels, int hw, int ct,
                      int groups) {
  constexpr int W = Elem<T>::kWidth;
  __shared__ __align__(16) float col_s[kThreads * W];  // [row group][column]
  __shared__ __align__(16) float col_q[kThreads * W];
  const long long row_stride = static_cast<long long>(channels) * hw;
  const int slots = (ct * hw + W - 1) / W;
  const int row_groups = kThreads / slots;
  const int rg = threadIdx.x / slots, slot = threadIdx.x - rg * slots;
  const int col = slot * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int c0 = g * ct;
    const int nch = min(ct, channels - c0);
    const int cols = nch * hw;
    const T* span0 = x + static_cast<long long>(c0) * hw;
    float s[W], q[W];
#pragma unroll
    for (int l = 0; l < W; ++l) s[l] = q[l] = 0.f;
    if (rg < row_groups) {
      for (int b = rg; b < batch; b += kLoads * row_groups) {
        // every load issued (masked ones from span0) before any is added
        float e[kLoads][W];
        if constexpr (kVector) {
          typename Elem<T>::Vec raw[kLoads];
#pragma unroll
          for (int r = 0; r < kLoads; ++r) {
            const int row = b + r * row_groups;
            const bool ok = row < batch && col < cols;
            raw[r] = Elem<T>::vec(span0 + (ok ? row * row_stride + col : 0));
          }
#pragma unroll
          for (int r = 0; r < kLoads; ++r) {
            Elem<T>::unpack(raw[r], e[r]);
            if (!(b + r * row_groups < batch && col < cols)) {
#pragma unroll
              for (int l = 0; l < W; ++l) e[r][l] = 0.f;
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < kLoads; ++r) {
            const int row = b + r * row_groups;
#pragma unroll
            for (int l = 0; l < W; ++l) {
              const bool ok = row < batch && col + l < cols;
              const float val = Elem<T>::one(span0 + (ok ? row * row_stride + col + l : 0));
              e[r][l] = ok ? val : 0.f;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kLoads; ++r) {
#pragma unroll
          for (int l = 0; l < W; ++l) {
            s[l] += e[r][l];
            q[l] = __fmaf_rn(e[r][l], e[r][l], q[l]);
          }
        }
      }
#pragma unroll
      for (int l = 0; l < W; l += 4) {
        *reinterpret_cast<float4*>(col_s + rg * slots * W + col + l) = make_float4(s[l], s[l + 1], s[l + 2], s[l + 3]);
        *reinterpret_cast<float4*>(col_q + rg * slots * W + col + l) = make_float4(q[l], q[l + 1], q[l + 2], q[l + 3]);
      }
    }
    __syncthreads();
    // the row groups' columns, in row-group order, into row group 0
    for (int i = threadIdx.x; i < cols; i += kThreads) {
      float as = col_s[i], aq = col_q[i];
      for (int r = 1; r < row_groups; ++r) {
        as += col_s[r * slots * W + i];
        aq += col_q[r * slots * W + i];
      }
      col_s[i] = as;
      col_q[i] = aq;
    }
    __syncthreads();
    for (int ch = warp; ch < nch; ch += kWarps) {
      float as = 0.f, aq = 0.f;
      for (int i = lane; i < hw; i += 32) {
        as += col_s[ch * hw + i];
        aq += col_q[ch * hw + i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        as += __shfl_down_sync(0xffffffffu, as, off);
        aq += __shfl_down_sync(0xffffffffu, aq, off);
      }
      if (lane == 0) {
        out[c0 + ch] = as;
        out[channels + c0 + ch] = aq;
      }
    }
    __syncthreads();  // col_s and col_q are reused by the next group
  }
}

template <typename T>
void launch(const void* x, float* out, float* part, int* tickets, int path, int vector, int batch, int channels,
            long long hw, int ct, int groups, int rows, int slices, int grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (path == 0) {
    if (vector) {
      bn_stats_runs_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, out, part, tickets, batch, channels, hw, rows,
                                                                   slices);
    } else {
      bn_stats_runs_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, out, part, tickets, batch, channels, hw, rows,
                                                                    slices);
    }
  } else {
    const int hw32 = static_cast<int>(hw);
    if (vector) {
      bn_stats_tiles_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, out, batch, channels, hw32, ct, groups);
    } else {
      bn_stats_tiles_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, out, batch, channels, hw32, ct, groups);
    }
  }
}

}  // namespace

// x: (batch, channels, hw) contiguous, dtype 0 = fp32, 1 = bf16. out: 2 *
// channels fp32 (sums, then sums of squares). path 0 = runs (ct = 1, groups
// = channels; part: fp32 scratch of 2 * channels * slices floats, unused when
// slices == 1; tickets: channels int32 counters, 0 on entry and on exit),
// 1 = tiles (slices = 1, rows = batch, ct * hw at most kThreads 16-byte
// vectors; part and tickets unused). vector = 1 requires a 16-byte aligned x
// and, on the runs path, hw % (16 / element size) == 0, on the tiles path
// channels * hw % (16 / element size) == 0 and ct * hw a multiple of it when
// groups > 1. Returns the cudaError_t of the launch (0 on success).
extern "C" int ihmr_bn_stats_forward(const void* x, int dtype, float* out, float* part, int* tickets, int path,
                                     int vector, int batch, int channels, long long hw, int ct, int groups, int rows,
                                     int slices, int grid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long tile_elements = kThreads * 16LL / (dtype == 0 ? 4 : 2);
  if (batch < 1 || channels < 1 || hw < 1 || ct < 1 || groups < 1 || rows < 1 || slices < 1 || grid < 1 ||
      (path != 0 && path != 1) || (path == 1 && (slices != 1 || ct * hw > tile_elements)) ||
      static_cast<long long>(rows) * hw > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    launch<float>(x, out, part, tickets, path, vector, batch, channels, hw, ct, groups, rows, slices, grid, stream);
  } else if (dtype == 1) {
    launch<uint16_t>(x, out, part, tickets, path, vector, batch, channels, hw, ct, groups, rows, slices, grid, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
