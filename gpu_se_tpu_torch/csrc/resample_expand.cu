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
// in the survivor window [lo_c, lo_c + B], lo_c = #{keys < cB}. The TPU
// kernel of resample_pallas2 exists to exploit that bound, with a
// 128-aligned window fetched by a scalar-prefetched DMA, a lane count and
// a one-hot MXU gather, and a global compare-reduce for lo_c. Here one
// block per chunk finds lo_c with one binary search, stages the window's
// <= B + 1 keys in shared memory (16 KB at B = 4096), and each thread
// searches shared memory (~log2(B) loads instead of ~log2(n) dependent
// L2 loads) and copies its slot's payload exactly. A block larger than
// the block's threads loops over its slots. Keys that are not strictly
// increasing (the raw `ends` of the direct route) can place an ancestor
// past the window; the search then goes on in device memory, so the
// kernel takes any non-decreasing keys, and the TPU kernels' window
// overflow has no counterpart here.
//
// Bound on the H100: at n = 2^20, 5 rows and m survivors it reads 4 B of
// key, 20 B of payload and 4 B of index per survivor and writes 24 B
// per slot (5 rows plus the ancestor): <= ~52 MiB, ~16 us at 3.35 TB/s.
// cp.async or TMA staging of the window is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "lower_bound.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStage = 8193;  // staged keys: a 8192-slot chunk's window

__global__ void expand_kernel(const int* __restrict__ keys, int L,
                              const float* __restrict__ payload, int rows,
                              const int* __restrict__ src_idx, int n,
                              int block, int stage, float* __restrict__ out,
                              int* __restrict__ anc) {
  extern __shared__ int s_keys[];
  __shared__ int s_lo;
  const int c0 = blockIdx.x * block;
  const int c1 = min(c0 + block, n);
  if (threadIdx.x == 0) s_lo = gst::lower_bound(keys, L, c0);
  __syncthreads();
  const int lo = s_lo;
  const int len = min(stage, L - lo);
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    s_keys[t] = __ldg(keys + lo + t);
  }
  __syncthreads();
  for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
    // every key before lo is < c0 <= i: the global lower bound is lo
    // plus the lower bound inside the window
    int a = 0;
    int m = len;
    while (m > 0) {
      const int half = m >> 1;
      if (s_keys[a + half] < i) {
        a += half + 1;
        m -= half + 1;
      } else {
        m = half;
      }
    }
    int j = lo + a;
    if (a == len && j < L) j += gst::lower_bound(keys + j, L - j, i);
    // keys[L-1] >= n-1 on every path of the filter; the clamp keeps a
    // malformed input (NaN weights) in bounds, as the plain version does
    if (j > L - 1) j = L - 1;
    anc[i] = src_idx != nullptr ? __ldg(src_idx + j) : j;
    for (int r = 0; r < rows; ++r) {
      out[static_cast<size_t>(r) * n + i] =
          __ldg(payload + static_cast<size_t>(r) * L + j);
    }
  }
}

}  // namespace

extern "C" {

// keys (L,) int32 non-decreasing; payload (rows, L) float32 row-major;
// src_idx (L,) int32 or null; out (rows, n), anc (n,) int32; chunks of
// `block` >= 1 slots, the last one ragged.
int gst_expand(const int* keys, int L, const float* payload, int rows,
               const int* src_idx, int n, int block, float* out, int* anc,
               void* stream) {
  if (n > 0 && L > 0) {
    const int stage = block < kMaxStage ? block + 1 : kMaxStage;
    const int grid = (n - 1) / block + 1;
    expand_kernel<<<grid, kThreads, stage * sizeof(int),
                    static_cast<cudaStream_t>(stream)>>>(
        keys, L, payload, rows, src_idx, n, block, stage, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
