// Ancestor search and gather for Hopper (sm_90a): the second half of the
// port's systematic resample, after `compact` (resample.cu).
//
// Replaces two Pallas TPU kernels that compute the same function:
// gpu_se_tpu/ops/resample_pallas4.py:76 `_kernel` (the tiled search and
// gather) and gpu_se_tpu/ops/resample_pallas2.py:178 `_expand_kernel`
// (the v2 expansion). Its input is the compacted survivor stream: keys
// (the survivors' `ends`, strictly increasing, then an INT_MAX tail),
// their payload columns and their original indices. For output slot i
// the ancestor is the first j with keys[j] >= i.
//
// Survivors own at least one slot each, so their keys are strictly
// increasing: the ancestors of the B slots [cB, cB + B) of chunk c lie
// in the survivor window [lo_c, lo_c + B], lo_c = #{keys < cB}, and the
// ancestors of two neighbouring slots differ by 0 or 1. The TPU kernel
// of resample_pallas2 exists to exploit the window bound, with a
// 128-aligned window fetched by a scalar-prefetched DMA, a lane count and
// a one-hot MXU gather, and a global compare-reduce for lo_c.
//
// Bound on the H100: memory. At n = 2^20, 5 rows and m survivors it
// reads 4 B of key, 20 B of payload and 4 B of index per survivor and
// writes 24 B per slot (5 rows plus the ancestor): 27 MB at m = 89 k,
// 0.008 ms at 3.35 TB/s. Nearly all of it is the writes, so what is
// left to win is latency in front of them and their width:
// * one block per chunk; one warp brackets lo_c by a 32-ary search (32
//   evenly spaced probes and a ballot per round, 4 rounds over 2^20 keys
//   where one thread's binary search took 20 dependent loads);
// * the window's <= B + 1 keys and their original indices go to shared
//   memory by cp.async (16 bytes where the source is aligned, 4 bytes at
//   the ragged ends; lo_c is arbitrary, so the shared copy starts at the
//   source's misalignment), which takes the index load out of the
//   per-slot chain;
// * each thread owns 4 consecutive slots: one binary search in shared
//   memory for the first, then a step of 0 or 1 for each following slot,
//   tried on the keys themselves. Where the keys repeat (the raw `ends`
//   of the direct route) the step can fail or the ancestor can lie past
//   the window: that slot then searches on in device memory, galloping
//   from where the last slot ended. So the kernel takes any
//   non-decreasing keys, chooses slot by slot from what the keys show,
//   and the TPU kernels' window overflow has no counterpart here;
// * per group of kRowGroup rows the 4 slots' values are loaded first and
//   then stored as one float4 a row (the ancestors as one int4) where
//   n and the chunk size are multiples of 4; 4-byte stores otherwise;
// * the register budget is held to kMinBlocks blocks per SM (4 x 256
//   threads leave 64 registers a thread; unbounded, the kernel took 80,
//   three blocks fit on an SM and a 1024-chunk launch ran in three waves).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lower_bound.cuh"
#include "warp_stage.cuh"

namespace {

using gst::misalignment;
using gst::stage_async;
using gst::warp_lower_bound;

constexpr int kThreads = 256;
constexpr int kMaxStage = 8193;  // staged keys: a 8192-slot chunk's window
constexpr int kRowGroup = 2;   // rows gathered before their stores
constexpr int kMinBlocks = 4;  // blocks per SM the registers are held to
constexpr int kStaticSharedLimit = 48 * 1024;

// ints of shared memory for one staged array: the window plus the up to 3
// entries the copy is shifted by, rounded up to whole 16 bytes
__host__ __device__ constexpr int stage_ints(int stage) {
  return (stage + 3 + 3) / 4 * 4;
}

// The first index j >= from with keys[j] >= v, or L; every key before
// `from` is < v. Doubling steps, then a binary search of the last one:
// ~2 log2 of the distance in loads.
__device__ __forceinline__ int gallop(const int* __restrict__ keys, int L,
                                      int from, int v) {
  int w = 1;
  while (from + w <= L && __ldg(keys + from + w - 1) < v) {
    from += w;
    w <<= 1;
  }
  const int len = min(w - 1, L - from);
  return from + gst::lower_bound(keys + from, len, v);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
expand_kernel(const int* __restrict__ keys, int L,
              const float* __restrict__ payload, int rows,
              const int* __restrict__ src_idx, int n, int block, int stage,
              float* __restrict__ out, int* __restrict__ anc) {
  extern __shared__ int4 s_mem[];
  __shared__ int s_lo;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * block;
  const int c1 = min(c0 + block, n);
  if (threadIdx.x < 32) {
    const int found = warp_lower_bound(keys, L, c0, lane);
    if (lane == 0) s_lo = found;
  }
  __syncthreads();
  const int lo = s_lo;
  const int len = min(stage, L - lo);
  const int key_mis = misalignment(keys + lo);
  int* s_keys = reinterpret_cast<int*>(s_mem);
  stage_async(s_keys, keys + lo, key_mis, len);
  s_keys += key_mis;  // s_keys[t] = keys[lo + t]
  int* s_idx = nullptr;
  if (src_idx != nullptr) {
    const int idx_mis = misalignment(src_idx + lo);
    s_idx = reinterpret_cast<int*>(s_mem) + stage_ints(stage);
    stage_async(s_idx, src_idx + lo, idx_mis, len);
    s_idx += idx_mis;  // s_idx[t] = src_idx[lo + t]
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // keys[j] for any j in [0, L): the staged copy where there is one
  auto key_at = [&](int j) {
    const int t = j - lo;
    return t < len ? s_keys[t] : __ldg(keys + j);  // j >= lo always
  };
  const bool wide = (n & 3) == 0 && (block & 3) == 0;
  const int quads = (c1 - c0 + 3) >> 2;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int i0 = c0 + 4 * q;
    const int slots = min(4, c1 - i0);
    // the first slot: every key before lo is < c0 <= i0, so the global
    // lower bound is lo plus the lower bound inside the window
    int a = 0;
    int m = len;
    while (m > 0) {
      const int half = m >> 1;
      if (s_keys[a + half] < i0) {
        a += half + 1;
        m -= half + 1;
      } else {
        m = half;
      }
    }
    int j = lo + a;
    if (a == len && j < L) j += gst::lower_bound(keys + j, L - j, i0);
    int js[4];
    js[0] = j;
#pragma unroll
    for (int s = 1; s < 4; ++s) {
      // every key before j is < i - 1: try j, then j + 1, then search on
      const int i = i0 + s;
      if (s < slots && j < L && key_at(j) < i) {
        ++j;
        if (j < L && key_at(j) < i) j = gallop(keys, L, j + 1, i);
      }
      js[s] = j;
    }
    // keys[L-1] >= n-1 on every path of the filter; the clamp keeps a
    // malformed input (NaN weights) in bounds, as the plain version does
    int from[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      js[s] = min(js[s], L - 1);
      // the clamp can land before the window (lo = L): t < 0 wraps
      const unsigned t = static_cast<unsigned>(js[s] - lo);
      from[s] = src_idx == nullptr               ? js[s]
                : t < static_cast<unsigned>(len) ? s_idx[t]
                                                 : __ldg(src_idx + js[s]);
    }
    if (wide) {
      *reinterpret_cast<int4*>(anc + i0) =
          make_int4(from[0], from[1], from[2], from[3]);
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < slots) anc[i0 + s] = from[s];
      }
    }
    for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
      float v[kRowGroup][4];
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) {
        if (r0 + g < rows) {
          const float* row = payload + static_cast<size_t>(r0 + g) * L;
#pragma unroll
          for (int s = 0; s < 4; ++s) v[g][s] = __ldg(row + js[s]);
        }
      }
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) {
        if (r0 + g < rows) {
          float* row = out + static_cast<size_t>(r0 + g) * n + i0;
          if (wide) {
            *reinterpret_cast<float4*>(row) =
                make_float4(v[g][0], v[g][1], v[g][2], v[g][3]);
          } else {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              if (s < slots) row[s] = v[g][s];
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// the most keys a block stages in shared memory
int gst_expand_max_stage() { return kMaxStage; }

// keys (L,) int32 non-decreasing; payload (rows, L) float32 row-major;
// src_idx (L,) int32 or null; out (rows, n), anc (n,) int32, both 16-byte
// aligned; chunks of `block` >= 1 slots, the last one ragged.
int gst_expand(const int* keys, int L, const float* payload, int rows,
               const int* src_idx, int n, int block, float* out, int* anc,
               void* stream) {
  if (n > 0 && L > 0) {
    const int stage = block < kMaxStage ? block + 1 : kMaxStage;
    const int grid = (n - 1) / block + 1;
    // one thread per 4 slots, whole warps, at most kThreads
    const int quads = block < 4 * kThreads ? (block + 3) / 4 : kThreads;
    const int threads = (quads + 31) / 32 * 32;
    const int shared = static_cast<int>(sizeof(int)) * stage_ints(stage) *
                       (src_idx != nullptr ? 2 : 1);
    if (shared > kStaticSharedLimit) {
      const cudaError_t err = cudaFuncSetAttribute(
          expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    expand_kernel<<<grid, threads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
        keys, L, payload, rows, src_idx, n, block, stage, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
