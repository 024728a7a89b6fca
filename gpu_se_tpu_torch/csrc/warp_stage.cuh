// A warp's 32-ary lower bound in device memory and a block's cp.async
// copy of an unaligned run of ints into shared memory, shared by
// resample_expand.cu and merge_path.cuh.
#pragma once

#include <cuda_pipeline_primitives.h>

#include <cstdint>

namespace gst {

constexpr unsigned kFull = 0xffffffffu;

// #{keys < v} over the non-decreasing keys[0, L), by one whole warp: each
// round 32 lanes probe 32 evenly spaced keys and a ballot keeps the one
// sub-range between two probes; ranges of at most 32 keys end it.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys,
                                                int L, int v, int lane) {
  int lo = 0;
  int hi = L;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const bool less = p < hi && __ldg(keys + p) < v;
    const int cnt = __popc(__ballot_sync(kFull, less));
    hi = min(hi, lo + (cnt + 1) * step - 1);
    lo = min(hi, lo + cnt * step);
  }
  const bool less = lo + lane < hi && __ldg(keys + lo + lane) < v;
  return lo + __popc(__ballot_sync(kFull, less));
}

// dst[mis + t] = src[t] for t in [0, len) by the whole block, where mis is
// src's misalignment in ints: both sides of a 16-byte copy are aligned.
__device__ __forceinline__ void stage_async(int* dst, const int* src, int mis,
                                            int len) {
  const int head = min((4 - mis) & 3, len);
  const int nvec = (len - head) >> 2;
  for (int t = threadIdx.x; t < nvec; t += blockDim.x) {
    __pipeline_memcpy_async(dst + mis + head + 4 * t, src + head + 4 * t, 16);
  }
  if (static_cast<int>(threadIdx.x) < head) {
    __pipeline_memcpy_async(dst + mis + threadIdx.x, src + threadIdx.x, 4);
  }
  const int t = head + 4 * nvec + threadIdx.x;
  if (t < len) __pipeline_memcpy_async(dst + mis + t, src + t, 4);
}

__device__ __forceinline__ int misalignment(const int* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

}  // namespace gst
