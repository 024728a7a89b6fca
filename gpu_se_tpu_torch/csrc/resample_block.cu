// One round of the integer-`ends` block merge for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of
// gpu_se_tpu/ops/resample_pallas_block.py: `_kernel` (:42, synchronous
// window fetches) and `_kernel_pipelined` (:231, the same function with
// double-buffered DMA). The two differ only in how the TPU schedules its
// VMEM windows, so one kernel serves both entry points.
//
// What a round computes. A shard of `n_local` output slots, the first at
// global slot `slot0`, meets one source block of `n_blk` entries of the
// globally monotonized `ends` (blocks arrive in ascending order). For
// local slot s, with global slot g = slot0 + s:
//   c = #{j < n_blk : ends[j] < g}          (a lower bound)
//   counts[s] += c
//   if finalized[s] == 0 and c < n_blk:  acc[s, :nx] = parts[c, :],
//                                         finalized[s] = 1
// so after the last block `counts` is the ancestor and `acc` its row. An
// ancestor in a later block leaves the slot open, as the TPU kernel's
// real-entry test does (:79-82). The state is updated in place, as the
// TPU kernel aliases its state buffers (input_output_aliases, :205/:389).
//
// The copy is exact. The TPU kernel gathers by `acc + onehot @ parts` on
// its matrix unit, which turns -0.0 into +0.0 and spreads a non-finite
// entry over every slot whose window holds it; the XLA path, which is
// the reference semantics, copies, and so does this kernel.
//
// Bound on the H100: one thread per slot with a global binary search,
// ~log2(n_blk) dependent loads of `ends` (4 MB at 2^20, resident in the
// 50 MB L2), then nx contiguous floats read and written per slot. The
// TPU kernel's resumable window walk and its carried window start exist
// only because its grid is sequential and its VMEM window bounded; a GPU
// thread can search the whole block, so none of that carries over. A
// block-cooperative bracket with a shared-memory search is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "lower_bound.cuh"

namespace {

__global__ void ends_merge_round_kernel(const int* __restrict__ ends,
                                        int n_blk,
                                        const float* __restrict__ parts,
                                        int nx, int slot0, int n_local,
                                        int* __restrict__ counts,
                                        float* __restrict__ acc, int cols,
                                        float* __restrict__ finalized) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_local) return;
  const int c = gst::lower_bound(ends, n_blk, slot0 + s);
  counts[s] += c;
  if (c < n_blk && finalized[s] == 0.0f) {
    const float* src = parts + static_cast<size_t>(c) * nx;
    float* dst = acc + static_cast<size_t>(s) * cols;
    for (int k = 0; k < nx; ++k) dst[k] = __ldg(src + k);
    finalized[s] = 1.0f;
  }
}

}  // namespace

extern "C" {

// ends (n_blk,) int32 ascending; parts (n_blk, nx) float32 row-major;
// counts (n_local,) int32, acc (n_local, cols) float32 row-major with
// cols >= nx, finalized (n_local,) float32: read and updated in place.
int gst_ends_merge_round(const int* ends, int n_blk, const float* parts,
                         int nx, int slot0, int n_local, int* counts,
                         float* acc, int cols, float* finalized,
                         void* stream) {
  if (n_local > 0) {
    const int threads = 256;
    ends_merge_round_kernel<<<(n_local + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ends, n_blk, parts, nx, slot0, n_local, counts, acc, cols, finalized);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
