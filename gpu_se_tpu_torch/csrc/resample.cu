// Systematic-resample kernels for Hopper (sm_90a): search+gather and
// survivor compaction over the monotonized integer `ends`.
//
// Both kernels replace the two Pallas TPU kernels of
// gpu_se_tpu/ops/resample_pallas4.py on the tiled particle-filter path.
// The TPU versions are shaped by a bounded VMEM window (the 3*tpb+8 tile
// window with its span-overflow telemetry row, one-hot MXU slab gathers,
// a staging ring with flushes). A GPU reads device memory directly from
// every thread, so none of that machinery carries over: the design
// follows what the kernels compute, not how the TPU blocks it.
//
// Conventions shared with the Python wrappers (ops/resample_pallas4.py):
// * `ends` / `keys` are int32 and non-decreasing; the ancestor of output
//   slot i is the first j with keys[j] >= i.
// * payloads are row-major (rows, L) float32 (structure of arrays), any
//   number of rows.
// * every function launches on the given stream, allocates nothing and
//   returns cudaGetLastError() of its launches (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "lower_bound.cuh"

namespace {

// ---------------------------------------------------------------------
// K1 search_gather
//
// Replaces resample_pallas4._kernel (gpu_se_tpu/ops/resample_pallas4.py:76).
// For each output slot i: j = lower_bound(keys, i), anc[i] = src_idx[j]
// (or j), out[:, i] = payload[:, j].
//
// Bound: at n = 2^20 and 5 payload rows it moves ~24 MB in and ~24 MB
// out, ~15 us of DRAM time at 3.35 TB/s. This first version is one
// thread per slot doing a global binary search, ~log2(L) dependent loads
// per slot; the keys array (4 MB at 2^20) fits in the 50 MB L2, so the
// searches should wait on L2 latency rather than on DRAM. The reads and
// writes of the gather are coalesced because ancestors are sorted:
// neighbouring slots read neighbouring (often equal) columns. A
// block-cooperative bracket with a shared-memory search is later work.
//
// The TPU kernel's window can overflow, which is why its caller runs a
// span check and may re-run it on compacted input; a global search has
// no window, so it is exact on any non-decreasing keys.
// ---------------------------------------------------------------------
__global__ void search_gather_kernel(const int* __restrict__ keys, int L,
                                     const float* __restrict__ payload,
                                     int rows,
                                     const int* __restrict__ src_idx, int n,
                                     float* __restrict__ out,
                                     int* __restrict__ anc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lo = gst::lower_bound(keys, L, i);
  // keys[L-1] >= n-1 on every path of the filter; the clamp keeps a
  // malformed input (NaN weights) in bounds, as the plain version does
  const int j = lo < L ? lo : L - 1;
  anc[i] = src_idx != nullptr ? __ldg(src_idx + j) : j;
  for (int r = 0; r < rows; ++r) {
    out[static_cast<size_t>(r) * n + i] =
        __ldg(payload + static_cast<size_t>(r) * L + j);
  }
}

// ---------------------------------------------------------------------
// K2 compact
//
// Replaces resample_pallas4._compact_kernel
// (gpu_se_tpu/ops/resample_pallas4.py:266). Keeps entry k where
// ends[k] > ends[k-1] (ends[-1] = -1): exactly the particles that parent
// at least one slot. Output is a stable partition of the n entries:
// survivors first (keys, original index, payload columns), then a pad
// tail of INT_MAX keys, index -1 and zero payload, so a search over the
// full length never needs the survivor count.
//
// The TPU kernel walks its grid in order and carries the running count
// from step to step. GPU blocks run in no order, so the count is a
// three-pass scan written here: per-block survivor counts (warp ballot
// and popcount), one block's exclusive scan of those counts (which also
// yields the total), then a scatter that recomputes the keep flags and
// ranks them inside the block. Bound: memory, ~(4 + 4 rows) bytes read
// and (8 + 4 rows) bytes written per entry plus one extra read of
// `ends` in the counting pass.
// ---------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;  // entries per block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool keep_at(const int* __restrict__ ends, int k,
                                        int n) {
  if (k >= n) return false;
  const int prev = k > 0 ? __ldg(ends + k - 1) : -1;
  return __ldg(ends + k) > prev;
}

__global__ void compact_count_kernel(const int* __restrict__ ends, int n,
                                     int* __restrict__ block_counts) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;
  int c = 0;
  for (int it = 0; it < kRounds; ++it) {
    const bool keep = keep_at(ends, base + it * kThreads + threadIdx.x, n);
    c += __popc(__ballot_sync(0xffffffffu, keep));
  }
  if (lane == 0) warp_total[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_total[w];
    block_counts[blockIdx.x] = s;
  }
}

// one block: exclusive scan of the per-block counts, plus the total
__global__ void scan_counts_kernel(const int* __restrict__ block_counts,
                                   int nblocks,
                                   int* __restrict__ block_offsets,
                                   int* __restrict__ count) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nblocks + kScanThreads - 1) / kScanThreads;
  const int begin = min(t * per, nblocks);
  const int end = min(begin + per, nblocks);
  int own = 0;
  for (int b = begin; b < end; ++b) own += block_counts[b];
  sums[t] = own;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = t >= off ? sums[t - off] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - own;
  for (int b = begin; b < end; ++b) {
    block_offsets[b] = run;
    run += block_counts[b];
  }
  if (t == kScanThreads - 1) count[0] = sums[t];
}

__global__ void compact_scatter_kernel(const int* __restrict__ ends,
                                       const float* __restrict__ payload,
                                       int rows, int n,
                                       const int* __restrict__ block_offsets,
                                       const int* __restrict__ count,
                                       int* __restrict__ c_keys,
                                       float* __restrict__ c_payload,
                                       int* __restrict__ c_idx) {
  __shared__ int warp_total[kWarps];
  __shared__ int warp_offset[kWarps];
  __shared__ int round_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int total = count[0];
  int kept_before = block_offsets[blockIdx.x];
  const int base = blockIdx.x * kTile;
  for (int it = 0; it < kRounds; ++it) {
    const int k = base + it * kThreads + threadIdx.x;
    const bool keep = keep_at(ends, k, n);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int own = lane < kWarps ? warp_total[lane] : 0;
      int v = own;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
      }
      if (lane < kWarps) warp_offset[lane] = v - own;
      if (lane == 31) round_total = v;
    }
    __syncthreads();
    if (k < n) {
      // survivors before k, over the whole array
      const int rank = kept_before + warp_offset[warp] +
                       __popc(ballot & lanes_below);
      if (keep) {
        c_keys[rank] = __ldg(ends + k);
        c_idx[rank] = k;
        for (int r = 0; r < rows; ++r) {
          c_payload[static_cast<size_t>(r) * n + rank] =
              __ldg(payload + static_cast<size_t>(r) * n + k);
        }
      } else {
        const int pos = total + (k - rank);  // the dead entries, in order
        c_keys[pos] = INT_MAX;
        c_idx[pos] = -1;
        for (int r = 0; r < rows; ++r) {
          c_payload[static_cast<size_t>(r) * n + pos] = 0.0f;
        }
      }
    }
    kept_before += round_total;
    __syncthreads();  // warp_total / warp_offset are rewritten next round
  }
}

}  // namespace

extern "C" {

int gst_search_gather(const int* keys, int L, const float* payload, int rows,
                      const int* src_idx, int n, float* out, int* anc,
                      void* stream) {
  if (n > 0) {
    const int threads = 256;
    search_gather_kernel<<<(n + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        keys, L, payload, rows, src_idx, n, out, anc);
  }
  return static_cast<int>(cudaGetLastError());
}

// number of int32 entries of scratch gst_compact needs for each of its
// block_counts and block_offsets arrays
int gst_compact_blocks(int n) { return (n + kTile - 1) / kTile; }

int gst_compact(const int* ends, const float* payload, int rows, int n,
                int* block_counts, int* block_offsets, int* c_keys,
                float* c_payload, int* c_idx, int* count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = gst_compact_blocks(n);
  if (nblocks == 0) return 0;
  compact_count_kernel<<<nblocks, kThreads, 0, s>>>(ends, n, block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_counts_kernel<<<1, kScanThreads, 0, s>>>(block_counts, nblocks,
                                                block_offsets, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter_kernel<<<nblocks, kThreads, 0, s>>>(
      ends, payload, rows, n, block_offsets, count, c_keys, c_payload, c_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
