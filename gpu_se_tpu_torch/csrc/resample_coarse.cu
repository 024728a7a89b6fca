// Coarse-window systematic resample for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gpu_se_tpu/ops/resample_coarse.py:117
// `_kernel`. Ancestors are non-decreasing, so output chunk c of 128
// slots draws only from the source rows [o[c], o[c + 1]], with
// o[c] = #{k : ends[k] < 128 c} the chunk boundaries
// (`chunk_boundaries`). For slot i of chunk c:
//   anc[i] = min(o[c] + #{k in [o[c], o[c + 1]) : ends[k] < i}, n - 1)
//   out[:, i] = payload[:, anc[i]]
// which is #{k : ends[k] < i}, the XLA path's ancestor, so the result is
// bit-equal to it given the same `ends`. The copy is exact, as the TPU
// kernel's lane gather is.
//
// The TPU kernel's window is four 128-entry source blocks per chunk,
// fixed by its static block shapes; a chunk whose ancestors span more
// rows overflows it, and the caller then falls back to the XLA path
// through a lax.cond. Here nothing overflows and there is no fallback.
//
// Bound on the H100: memory. At the flat path's input (n = 2^20, 5 rows,
// m survivors) it reads the 4 MB of `ends` and the survivors' 20m bytes
// of payload and writes 24 bytes per slot: ~31 MB, 0.009 ms at 3.35
// TB/s. The payload is (rows, n), so a survivor's value costs a 32-byte
// sector in each row, not 4 bytes: ~40 MB at 89k survivors, where about
// half the sectors of a row hold one.
//
// The design. `o` already holds the merge path's split at every chunk
// boundary: every key of chunk c's window has 128 c <= ends[k] < 128 (c +
// 1). So a block takes kChunks chunks, the slots [j0, j0 + ns), and knows
// its keys [o[c0], o[c0 + kChunks]) from two loads: no diagonal search,
// no look-back.
// * The block stages every stride-th key of its range in shared memory by
//   cp.async, stride = max(1, ceil(keys / kStage)): every key when the
//   range fits the stage (kStage, four times the mean), samples of a
//   longer one (one survivor: the last chunk holds every key from the
//   survivor on; heavy tails: long runs of dead particles).
// * Its threads split the merge of those keys with its slots evenly along
//   its diagonal and walk it (merge_walk, as merge_block's walk: a key
//   goes first iff key < slot, so ties fall as searchsorted(left)). Keys
//   repeat (dead particles are runs of equal `ends`), so the diagonal, not
//   the slots, balances the threads.
// * A slot's count then lies between two neighbouring samples: each thread
//   searches that gap, at most stride - 1 keys (none at stride 1), in
//   device memory for kThreadSlots slots at once, so its loads overlap. No
//   block reads a long range alone, and no thread makes a long chain of
//   loads. A second path that staged a fitting range by 16-byte copies
//   read 1-2% faster on an H100 (PERF.md): not worth its branch.
// * The counts wait in shared memory; the epilogue (gather_store, shared
//   with cumsum_merge) gathers a quad of slots' rows before it stores a
//   float4 a row and an int4 of ancestors.
// Eight chunks a block (1024 blocks at 2^20, two waves at 4 blocks an SM)
// read fastest at the flat path's input: 16 and 32 chunks put every block
// in one wave, where no block's staging and walk overlap another's stores
// (PERF.md). The first design ran one block of 128 threads a chunk,
// each thread a binary search of its window in device memory, then
// 4-byte stores.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

using gst::kMergeThreads;

constexpr int kChunk = 128;                // output slots per chunk
constexpr int kChunks = 8;                 // chunks a block takes
constexpr int kSlots = kChunk * kChunks;   // a block's slots
constexpr int kStage = 4 * kSlots;         // keys a block stages at most
constexpr int kThreadSlots = kSlots / kMergeThreads;  // a thread refines
constexpr int kMinBlocks = 4;  // blocks per SM the registers are held to

struct Shared {
  int keys[kStage];
  int counts[kSlots];
};

// the target of slot i is i itself
struct SlotTarget {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};

// The counts of the slots threadIdx.x + u kMergeThreads (u <
// kThreadSlots) of a block: cnt[s] holds q = #{samples <
// target}, so the count lies in (i0 + (q - 1) stride, min(i0 + q stride,
// i0 + nk)]; a binary search of each gap, all of a thread's searches
// advancing together so that their loads overlap.
__device__ __forceinline__ void refine_counts(const int* __restrict__ ends,
                                              int i0, int nk, int stride,
                                              int j0, int ns, int* cnt) {
  int lo[kThreadSlots], len[kThreadSlots];
#pragma unroll
  for (int u = 0; u < kThreadSlots; ++u) {
    const int s = threadIdx.x + u * kMergeThreads;
    const int q = s < ns ? cnt[s] : 0;
    lo[u] = q == 0 ? i0 : i0 + (q - 1) * stride + 1;
    len[u] = q == 0 ? 0 : min(i0 + q * stride, i0 + nk) - lo[u];
  }
  for (bool more = true; more;) {
    more = false;
#pragma unroll
    for (int u = 0; u < kThreadSlots; ++u) {
      if (len[u] > 0) {
        const int half = len[u] >> 1;
        const int mid = lo[u] + half;
        if (__ldg(ends + mid) < j0 + static_cast<int>(threadIdx.x) +
                                    u * kMergeThreads) {
          lo[u] = mid + 1;
          len[u] -= half + 1;
        } else {
          len[u] = half;
        }
        more |= len[u] > 0;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kThreadSlots; ++u) {
    const int s = threadIdx.x + u * kMergeThreads;
    if (s < ns) cnt[s] = lo[u];
  }
}

__global__ void __launch_bounds__(kMergeThreads, kMinBlocks)
coarse_gather_kernel(const int* __restrict__ ends, const int* __restrict__ o,
                     const float* __restrict__ payload, int rows, int n,
                     float* __restrict__ out, int* __restrict__ anc) {
  __shared__ Shared sh;
  const int c0 = blockIdx.x * kChunks;
  const int c1 = min(c0 + kChunks, n / kChunk);
  const int j0 = c0 * kChunk;
  const int ns = (c1 - c0) * kChunk;  // the block's slots [j0, j0 + ns)
  const int i0 = __ldg(o + c0);
  const int nk = max(__ldg(o + c1) - i0, 0);  // and keys [i0, i0 + nk)
  // stage the keys, or every stride-th of them: sk[q] = ends[i0 + q stride]
  const int stride = max(1, (nk + kStage - 1) / kStage);
  const int nq = (nk + stride - 1) / stride;
  for (int q = threadIdx.x; q < nq; q += kMergeThreads) {
    __pipeline_memcpy_async(sh.keys + q, ends + i0 + q * stride, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int nb = nq + ns;
  const int items = (nb + kMergeThreads - 1) / kMergeThreads;
  const int dt = min(static_cast<int>(threadIdx.x) * items, nb);
  gst::merge_walk(sh.keys, nq, ns, j0, SlotTarget{}, 0, dt,
                  min(dt + items, nb), sh.counts);
  __syncthreads();
  refine_counts(ends, i0, nk, stride, j0, ns, sh.counts);
  __syncthreads();
  gst::gather_store(sh.counts, j0, j0 + ns, payload, rows, n, out, anc);
}

}  // namespace

extern "C" {

// the chunks a block takes; the keys it stages at most
int gst_coarse_chunks() { return kChunks; }
int gst_coarse_stage() { return kStage; }

// ends (n,) int32 ascending; o (n / 128 + 1,) int32 chunk boundaries;
// payload (rows, n) float32 row-major; out (rows, n), anc (n,) int32,
// both 16-byte aligned. n is a multiple of 128.
int gst_coarse_gather(const int* ends, const int* o, const float* payload,
                      int rows, int n, float* out, int* anc, void* stream) {
  if (n > 0) {
    const int chunks = n / kChunk;
    coarse_gather_kernel<<<(chunks + kChunks - 1) / kChunks, kMergeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        ends, o, payload, rows, n, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
