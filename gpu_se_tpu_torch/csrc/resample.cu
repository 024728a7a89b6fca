// Survivor compaction for Hopper (sm_90a) over the monotonized integer
// `ends`: the first half of the port's systematic resample. The second
// half, the ancestor search and gather over the compacted survivors, is
// `expand` (resample_expand.cu).
//
// The TPU version is shaped by a bounded VMEM window (the 3*tpb+8 tile
// window with its span-overflow telemetry row, one-hot MXU slab gathers,
// a staging ring with flushes). A GPU reads device memory directly from
// every thread, so none of that machinery carries over: the design
// follows what the kernel computes, not how the TPU blocks it.
//
// Conventions shared with the Python wrapper (ops/resample_pallas4.py):
// * `ends` is int32 and non-decreasing;
// * payloads are row-major (rows, n) float32 (structure of arrays), any
//   number of rows;
// * gst_compact launches on the given stream, allocates nothing and
//   returns cudaGetLastError() of its launches (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

// ---------------------------------------------------------------------
// K2 compact
//
// Replaces resample_pallas4._compact_kernel
// (gpu_se_tpu/ops/resample_pallas4.py:266) and resample_pallas2's
// (gpu_se_tpu/ops/resample_pallas2.py:69). Keeps entry k where
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
// ranks them inside the block. Bound: memory, 4 bytes of `ends` per
// entry and 4 rows bytes per survivor read, (8 + 4 rows) bytes written
// per entry, plus one extra read of `ends` in the counting pass.
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
