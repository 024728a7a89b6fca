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
// (arange + r) / n_t with a device tensor n_t does: it is __fdiv_rn, in
// the diagonal search, the per-thread search and the walk alike (one
// formula, PositionTarget), and the build takes no --use_fast_math, or
// the two part at ties.
//
// The copy is exact. The TPU kernels gather by `acc + onehot @ parts` on
// the matrix unit, which turns -0.0 into +0.0 and spreads a non-finite
// entry over every slot whose window holds it; the XLA path, which is
// the reference semantics, copies, and so does this kernel.
//
// Bound on the H100: memory. At the flat path's input (n = 2^20, 5 rows,
// m survivors) it reads the 4 MB of `cs` and the survivors' 20m bytes of
// payload and writes 24 bytes per slot (5 rows and the ancestor): ~31 MB,
// 0.009 ms at 3.35 TB/s. The TPU kernels' window walk, resumable window
// start and DMA double buffering exist because the TPU grid is
// sequential and its VMEM window bounded; here the slots' positions are
// merged with `cs` by the merge path (merge_path.cuh: each block 4096
// items of keys and slots, 16 a thread, each key read once, coalesced,
// each slot's count in shared memory; 2048 items a block, as
// ends_merge_round takes, read 16% slower at the flat path's input). The
// payload layout (rows, n) is already coalesced across slots, so the
// epilogue (gst::gather_store, shared with coarse_gather) has each thread
// take an aligned quad of slots, load all their rows first and store one
// float4 per row and one int4 of ancestors. The
// registers are held to kMinBlocks blocks per SM: unbounded the kernel
// took 80 registers, three blocks fit on an SM and a 2^20 merge ran in
// almost three waves.

#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

using gst::kMergeThreads;

constexpr int kItems = 16;    // merged items a thread walks
using Shared = gst::MergeShared<kItems, float>;
constexpr int kMinBlocks = 4;  // blocks per SM the registers are held to

// the target of slot i: its stratified position (i + r) / n
struct PositionTarget {
  float r;
  float n;
  __device__ __forceinline__ float operator()(int i) const {
    return __fdiv_rn(static_cast<float>(i) + r, n);
  }
};

__global__ void __launch_bounds__(kMergeThreads, kMinBlocks)
cumsum_merge_kernel(const float* __restrict__ cs,
                    const float* __restrict__ payload, int rows,
                    const float* __restrict__ r, int n,
                    float* __restrict__ out, int* __restrict__ anc) {
  __shared__ Shared sh;
  const gst::MergeSlots slots = gst::merge_block(
      cs, n, n, PositionTarget{__ldg(r), static_cast<float>(n)}, 0, sh);
  gst::gather_store(sh.counts, slots.j0, slots.j1, payload, rows, n, out,
                    anc);
}

}  // namespace

extern "C" {

// the threads of a merge-path block; the merged items one thread walks
int gst_merge_threads() { return kMergeThreads; }
int gst_cumsum_merge_thread_items() { return kItems; }

// cs (n,) float32 ascending; payload (rows, n) float32 row-major; r a
// pointer to one float32 on the device; out (rows, n), anc (n,) int32,
// both 16-byte aligned.
int gst_cumsum_merge(const float* cs, const float* payload, int rows,
                     const float* r, int n, float* out, int* anc,
                     void* stream) {
  if (n > 0) {
    const long long items = 2LL * n;
    const int grid =
        static_cast<int>((items + Shared::kBlock - 1) / Shared::kBlock);
    cumsum_merge_kernel<<<grid, kMergeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        cs, payload, rows, r, n, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
