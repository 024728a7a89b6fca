// Coarse-window systematic resample for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gpu_se_tpu/ops/resample_coarse.py:117
// `_kernel`. Ancestors are non-decreasing, so output chunk ch of 128
// slots draws only from the source rows [o[ch], o[ch + 1]], with
// o[ch] = #{k : ends[k] < 128 ch} the chunk boundaries
// (`chunk_boundaries`). For slot i of chunk ch:
//   anc[i] = o[ch] + #{k in [o[ch], o[ch + 1]) : ends[k] < i}
//   out[:, i] = payload[:, anc[i]]
// which is #{k : ends[k] < i}, the XLA path's ancestor, so the result is
// bit-equal to it given the same `ends`.
//
// The TPU kernel's window is four 128-entry source blocks per chunk,
// fixed by its static block shapes; a chunk whose ancestors span more
// rows overflows it, and the caller then falls back to the XLA path
// through a lax.cond. Here each chunk searches its own window
// [o[ch], o[ch + 1]) of whatever length, so nothing overflows and there
// is no fallback. The copy is exact, as the TPU kernel's lane gather is.
//
// Bound on the H100: one block of 128 threads per chunk; each thread
// does ~log2(window) dependent loads of `ends`, and a block's threads
// read the same few cache lines; then `rows` coalesced reads and writes.
// Staging the window in shared memory is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "lower_bound.cuh"

namespace {

constexpr int kChunk = 128;  // output slots per chunk, as the TPU kernel's

__global__ void coarse_gather_kernel(const int* __restrict__ ends,
                                     const int* __restrict__ o,
                                     const float* __restrict__ payload,
                                     int rows, int n, float* __restrict__ out,
                                     int* __restrict__ anc) {
  const int ch = blockIdx.x;
  const int i = ch * kChunk + threadIdx.x;
  if (i >= n) return;
  const int lo = __ldg(o + ch);
  const int hi = __ldg(o + ch + 1);
  int j = lo + gst::lower_bound(ends + lo, hi - lo, i);
  // `ends` from ends_from_weights ends at n - 1, so j < n already; the
  // clamp keeps a malformed `ends` from reading past the payload
  if (j > n - 1) j = n - 1;
  anc[i] = j;
  for (int k = 0; k < rows; ++k) {
    out[static_cast<size_t>(k) * n + i] =
        __ldg(payload + static_cast<size_t>(k) * n + j);
  }
}

}  // namespace

extern "C" {

// ends (n,) int32 ascending; o (n / 128 + 1,) int32 chunk boundaries;
// payload (rows, n) float32 row-major; out (rows, n), anc (n,) int32.
// n is a multiple of 128.
int gst_coarse_gather(const int* ends, const int* o, const float* payload,
                      int rows, int n, float* out, int* anc, void* stream) {
  if (n > 0) {
    coarse_gather_kernel<<<n / kChunk, kChunk, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        ends, o, payload, rows, n, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
