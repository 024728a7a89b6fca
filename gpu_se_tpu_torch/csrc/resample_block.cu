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
// TPU kernel aliases its state buffers (input_output_aliases, :205/:389);
// acc[:, nx:] is left as it was.
//
// The copy is exact. The TPU kernel gathers by `acc + onehot @ parts` on
// its matrix unit, which turns -0.0 into +0.0 and spreads a non-finite
// entry over every slot whose window holds it; the XLA path, which is
// the reference semantics, copies, and so does this kernel.
//
// Bound on the H100: memory. At the flat path's input (n_blk = n_local =
// 2^20, nx = 5, m survivors) a round reads the 4 MB of `ends` and the
// survivors' 20m bytes of `parts`, reads and writes `counts` and
// `finalized` (16 MB) and writes 20 bytes of `acc` per slot (20 MB):
// ~44 MB, 0.013 ms at 3.35 TB/s. An `acc` row at nx = 5 is 20 of its 32
// bytes, so the memory system may complete each 32-byte sector by a
// read; the bound counts only the bytes written. The TPU kernel's
// resumable window walk exists because its grid is sequential and its
// VMEM window bounded; here the round is a merge path
// (merge_path.cuh), so every key is read once, coalesced:
// * clip: each block counts a_lo = #{ends < slot0} and a_hi = #{ends <
//   slot0 + n_local} (one warp each, 32-ary); only ends[a_lo, a_hi) is
//   merged with the n_local slots and every count is offset by a_lo, so
//   a ring round whose block lies wholly below or above the shard merges
//   no key at all;
// * the merge path gives each block 2048 items of keys and slots (8 a
//   thread; 16, as cumsum_merge takes, read 8% slower at the flat path's
//   input) and each slot its count in shared memory;
// * the state is then walked in slot order: `counts += c` and the
//   `finalized` test-and-set as int4/float4 over aligned quads of slots
//   (scalar at the block's ragged ends or where the state is not 16-byte
//   aligned), then the copies spread as (slot, column) pairs over the
//   threads, so that neighbouring lanes read neighbouring floats of
//   `parts` (ancestors are sorted) and write neighbouring floats of `acc`;
//   one thread copying its own row made a warp's store touch 32 rows.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "merge_path.cuh"

namespace {

using gst::kMergeThreads;

constexpr int kItems = 8;  // merged items a thread walks
using Shared = gst::MergeShared<kItems, int>;

// the target of local slot s: its global slot
struct GlobalSlot {
  int slot0;
  __device__ __forceinline__ int operator()(int s) const { return slot0 + s; }
};

__global__ void __launch_bounds__(kMergeThreads)
ends_merge_round_kernel(const int* __restrict__ ends, int n_blk,
                        const float* __restrict__ parts, int nx, int slot0,
                        int n_local, int* __restrict__ counts,
                        float* __restrict__ acc, int cols,
                        float* __restrict__ finalized) {
  __shared__ Shared sh;
  __shared__ int s_clip[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int a = gst::warp_lower_bound(ends, n_blk,
                                        warp ? slot0 + n_local : slot0,
                                        threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) s_clip[warp] = a;
  }
  __syncthreads();
  const int a_lo = s_clip[0];
  const int n_keys = s_clip[1] - a_lo;
  if (static_cast<int>(blockIdx.x) * Shared::kBlock >= n_keys + n_local) {
    return;
  }
  const gst::MergeSlots slots = gst::merge_block(
      ends + a_lo, n_keys, n_local, GlobalSlot{slot0}, a_lo, sh);
  const int j0 = slots.j0;
  const int j1 = slots.j1;
  int* cnt = sh.counts;  // cnt[s - j0]: c, then the row to copy or -1

  // c into counts and finalized; the row slot s copies, or -1
  auto settle = [n_blk](int c, int& count, float& fin) {
    count += c;
    if (c < n_blk && fin == 0.0f) {
      fin = 1.0f;
      return c;
    }
    return -1;
  };
  const bool wide = ((reinterpret_cast<uintptr_t>(counts) |
                      reinterpret_cast<uintptr_t>(finalized)) & 15) == 0;
  int q0, q1;
  gst::aligned_quads(j0, j1, wide, q0, q1);
  for (int q = threadIdx.x; q < (q1 - q0) >> 2; q += blockDim.x) {
    const int s = q0 + 4 * q;
    int4 count = *reinterpret_cast<const int4*>(counts + s);
    float4 fin = *reinterpret_cast<const float4*>(finalized + s);
    int* c = cnt + (s - j0);
    c[0] = settle(c[0], count.x, fin.x);
    c[1] = settle(c[1], count.y, fin.y);
    c[2] = settle(c[2], count.z, fin.z);
    c[3] = settle(c[3], count.w, fin.w);
    *reinterpret_cast<int4*>(counts + s) = count;
    *reinterpret_cast<float4*>(finalized + s) = fin;
  }
  const int n_head = q0 - j0;
  for (int t = threadIdx.x; t < n_head + (j1 - q1); t += blockDim.x) {
    const int s = t < n_head ? j0 + t : q1 + (t - n_head);
    int count = counts[s];
    float fin = finalized[s];
    cnt[s - j0] = settle(cnt[s - j0], count, fin);
    counts[s] = count;
    finalized[s] = fin;
  }
  __syncthreads();

  // the copies, pair p = (slot j0 + p / nx, column p % nx)
  int s = threadIdx.x / nx;
  int col = threadIdx.x - s * nx;
  const int ds = blockDim.x / nx;
  const int dc = blockDim.x - ds * nx;
  for (int p = threadIdx.x; p < (j1 - j0) * nx; p += blockDim.x) {
    const int c = cnt[s];
    if (c >= 0) {
      acc[static_cast<size_t>(j0 + s) * cols + col] =
          __ldg(parts + static_cast<size_t>(c) * nx + col);
    }
    s += ds;
    col += dc;
    if (col >= nx) {
      col -= nx;
      ++s;
    }
  }
}

}  // namespace

extern "C" {

// the merged items one thread walks
int gst_ends_merge_thread_items() { return kItems; }

// ends (n_blk,) int32 non-decreasing; parts (n_blk, nx) float32 row-major;
// counts (n_local,) int32, acc (n_local, cols) float32 row-major with
// cols >= nx, finalized (n_local,) float32: read and updated in place.
// slot0 + n_local must fit an int32.
int gst_ends_merge_round(const int* ends, int n_blk, const float* parts,
                         int nx, int slot0, int n_local, int* counts,
                         float* acc, int cols, float* finalized,
                         void* stream) {
  if (n_local > 0) {
    // the most items the merge can hold: every key inside the shard
    const long long items = static_cast<long long>(n_blk) + n_local;
    const int grid =
        static_cast<int>((items + Shared::kBlock - 1) / Shared::kBlock);
    ends_merge_round_kernel<<<grid, kMergeThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ends, n_blk, parts, nx, slot0, n_local, counts, acc, cols, finalized);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
