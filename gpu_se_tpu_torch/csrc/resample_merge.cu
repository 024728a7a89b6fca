// Cumsum-domain merge resample for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that compute one function:
// gpu_se_tpu/ops/resample_pallas3.py:43 `_kernel` (v3, double-buffered
// window DMA) and gpu_se_tpu/ops/resample_pallas.py:35 `_kernel` (v1,
// synchronous fetches). For output slot i of n:
//   u = (float(i) + r) / float(n)            IEEE float32 add and divide
//   c = #{k : cs[k] < u}                     cs the normalized, cummaxed
//                                            float32 cumsum (ascending)
//   anc[i] = min(c, n - 1),  out[:, i] = payload[:, anc[i]]
// The division must round as IEEE `/` does, as the plain version's
// (arange + r) / n_t with a device tensor n_t does: build without
// --use_fast_math (nvcc's default -prec-div=true), or the two part at
// ties.
//
// The copy is exact. The TPU kernels gather by `acc + onehot @ parts` on
// the matrix unit, which turns -0.0 into +0.0 and spreads a non-finite
// entry over every slot whose window holds it; the XLA path, which is
// the reference semantics, copies, and so does this kernel.
//
// Bound on the H100: one thread per slot, ~log2(n) dependent loads of
// `cs` (4 MB at 2^20, resident in the 50 MB L2), then `rows` coalesced
// reads and writes (ancestors are sorted, so neighbouring slots read
// neighbouring columns). The TPU kernels' window walk, resumable window
// start and DMA double buffering exist because the TPU grid is
// sequential and its VMEM window bounded; none of that carries over.

#include <cuda_runtime.h>

#include <cstddef>

#include "lower_bound.cuh"

namespace {

__global__ void cumsum_merge_kernel(const float* __restrict__ cs,
                                    const float* __restrict__ payload,
                                    int rows, const float* __restrict__ r,
                                    int n, float* __restrict__ out,
                                    int* __restrict__ anc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float u = (static_cast<float>(i) + __ldg(r)) / static_cast<float>(n);
  const int c = gst::lower_bound(cs, n, u);
  const int j = c < n ? c : n - 1;
  anc[i] = j;
  for (int k = 0; k < rows; ++k) {
    out[static_cast<size_t>(k) * n + i] =
        __ldg(payload + static_cast<size_t>(k) * n + j);
  }
}

}  // namespace

extern "C" {

// cs (n,) float32 ascending; payload (rows, n) float32 row-major; r a
// pointer to one float32 on the device; out (rows, n), anc (n,) int32.
int gst_cumsum_merge(const float* cs, const float* payload, int rows,
                     const float* r, int n, float* out, int* anc,
                     void* stream) {
  if (n > 0) {
    const int threads = 256;
    cumsum_merge_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        cs, payload, rows, r, n, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
