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
// * gst_compact runs on the given stream (one memset of its scratch words
//   and one kernel launch), allocates nothing and returns the first CUDA
//   error of the two (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

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
// Bound on the H100: memory. With m survivors it reads 4 n bytes of
// `ends` and 4 rows m bytes of payload and writes (8 + 4 rows) n bytes:
// 37 MB at n = 2^20, 5 rows, m = 89 k, 0.011 ms at 3.35 TB/s. The
// survivors' payload reads touch a 32-byte sector per 4-byte value, so
// the memory system moves more than the counted 4 rows m.
//
// The TPU kernel walks its grid in order and carries the running count
// from step to step. GPU blocks run in no order, so the count is a
// single-pass scan with decoupled look-back, all in one launch:
// * a block takes its tile of kTile entries from an atomic ticket, not
//   from blockIdx, so a tile only ever waits on tiles that already run;
// * each thread loads its entries as int4 (the left neighbour of a
//   vector's first entry comes by shuffle, one extra load per warp),
//   ranks its keep flags in the warp by shuffles, and one block scan
//   over the kUnits warp totals gives the tile's count;
// * the tile publishes (status, value) as one 64-bit word: its count as
//   an aggregate, and after looking back over its predecessors' words
//   (one warp, 32 words a round, until it meets an inclusive prefix)
//   its inclusive prefix. The value travels in the word itself, so no
//   fence is needed between a value and its status;
// * the dead entries are all alike, so their order is free: entry k goes
//   to n - 1 - (k - rank_k), which over a tile is one contiguous run
//   [n - dead_before - dead_in_tile, n - dead_before) that the block
//   fills with 16-byte stores. They are evict-first stores: nothing
//   reads the tail back, and left in L2 it pushes out the payload the
//   survivors are gathered from. No pass needs the grand total; the last
//   tile writes it to `count`;
// * the tile's survivors first meet in shared memory, in order, so that
//   every lane of the gather is busy: survivor s of the tile goes to
//   prefix + s, neighbouring lanes to neighbouring addresses, a group of
//   rows loaded before it is stored.
// ---------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;                      // int4 vectors per thread
constexpr int kTile = kThreads * 4 * kVecs;   // entries per tile
constexpr int kUnits = kWarps * kVecs;        // warp totals per tile
static_assert(kUnits <= 32, "one warp scans the warp totals");
constexpr int kRowGroup = 5;  // rows gathered before their stores
constexpr unsigned kFull = 0xffffffffu;

using word_t = unsigned long long;
constexpr unsigned kEmpty = 0;      // the memset's state
constexpr unsigned kAggregate = 1;  // value = the tile's own count
constexpr unsigned kInclusive = 2;  // value = survivors up to its end

__device__ __forceinline__ word_t pack(unsigned status, int value) {
  return (static_cast<word_t>(status) << 32) | static_cast<unsigned>(value);
}
__device__ __forceinline__ unsigned status_of(word_t w) {
  return static_cast<unsigned>(w >> 32);
}
__device__ __forceinline__ int value_of(word_t w) {
  return static_cast<int>(static_cast<unsigned>(w));
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Survivors before tile `tile` (> 0), by one whole warp: each round reads
// the 32 words before `tile - done`, waits until none is empty, and sums
// the aggregates down to the nearest inclusive prefix.
__device__ __forceinline__ int look_back(const volatile word_t* tiles,
                                         int tile, int lane) {
  int excl = 0;
  for (int look = tile - 1;; look -= 32) {
    const int idx = look - lane;
    word_t w;
    do {
      w = idx >= 0 ? tiles[idx] : pack(kInclusive, 0);
    } while (__any_sync(kFull, status_of(w) == kEmpty));
    const unsigned inclusive =
        __ballot_sync(kFull, status_of(w) == kInclusive);
    if (inclusive != 0u) {
      const int first = __ffs(inclusive) - 1;
      return excl + warp_sum(lane <= first ? value_of(w) : 0);
    }
    excl += warp_sum(value_of(w));
  }
}

// p[0, len) = bits, by the whole block: 16-byte stores over the aligned
// middle, 4-byte stores at the ragged ends.
__device__ __forceinline__ void fill_run(int* __restrict__ p, int len,
                                         int bits) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  const int head = min((4 - mis) & 3, len);
  const int nvec = (len - head) >> 2;
  int4* pv = reinterpret_cast<int4*>(p + head);
  const int4 v = make_int4(bits, bits, bits, bits);
  for (int t = threadIdx.x; t < nvec; t += kThreads) __stcs(pv + t, v);
  if (static_cast<int>(threadIdx.x) < head) p[threadIdx.x] = bits;
  const int t = head + 4 * nvec + threadIdx.x;
  if (t < len) p[t] = bits;
}

// words[0] is the ticket, words[1 + t] tile t's (status, value); all zero
// at launch.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ ends,
               const float* __restrict__ payload, int rows, int n,
               int ntiles, word_t* words,
               int* __restrict__ c_keys, float* __restrict__ c_payload,
               int* __restrict__ c_idx, int* __restrict__ count) {
  __shared__ int s_tile;
  __shared__ int s_unit[kUnits];
  __shared__ int s_excl;
  __shared__ int s_k[kTile];    // the tile's survivors: original index
  __shared__ int s_key[kTile];  // and key
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(words), 1u));
  }
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile;
  volatile word_t* tiles = words + 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(ends) & 15) == 0;

  // keep flags of this thread's 4 kVecs entries and their rank in the warp
  int key[kVecs][4];
  unsigned keep[kVecs];
  int warp_excl[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int k0 = base + (i * kThreads + threadIdx.x) * 4;
    int4 v = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
    if (aligned && k0 + 3 < n) {
      v = __ldg(reinterpret_cast<const int4*>(ends + k0));
    } else {
      if (k0 < n) v.x = __ldg(ends + k0);
      if (k0 + 1 < n) v.y = __ldg(ends + k0 + 1);
      if (k0 + 2 < n) v.z = __ldg(ends + k0 + 2);
      if (k0 + 3 < n) v.w = __ldg(ends + k0 + 3);
    }
    int prev = __shfl_up_sync(kFull, v.w, 1);
    if (lane == 0) prev = (k0 > 0 && k0 < n) ? __ldg(ends + k0 - 1) : -1;
    unsigned m = 0;
    if (k0 < n && v.x > prev) m |= 1u;
    if (k0 + 1 < n && v.y > v.x) m |= 2u;
    if (k0 + 2 < n && v.z > v.y) m |= 4u;
    if (k0 + 3 < n && v.w > v.z) m |= 8u;
    key[i][0] = v.x;
    key[i][1] = v.y;
    key[i][2] = v.z;
    key[i][3] = v.w;
    keep[i] = m;
    const int c = __popc(m);
    const int incl = warp_inclusive_scan(c, lane);
    warp_excl[i] = incl - c;
    if (lane == 31) s_unit[i * kWarps + warp] = incl;
  }
  __syncthreads();

  // one scan over the warp totals, by every warp for itself
  const int own = lane < kUnits ? s_unit[lane] : 0;
  const int unit_incl = warp_inclusive_scan(own, lane);
  const int tile_count = __shfl_sync(kFull, unit_incl, 31);
  int unit_excl[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    unit_excl[i] = __shfl_sync(kFull, unit_incl - own, i * kWarps + warp);
  }

  // the tile's survivors, in order, side by side in shared memory
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int k0 = base + (i * kThreads + threadIdx.x) * 4;
    int s = unit_excl[i] + warp_excl[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((keep[i] >> j) & 1u) {
        s_k[s] = k0 + j;
        s_key[s] = key[i][j];
        ++s;
      }
    }
  }

  // publish the aggregate, look back, publish the inclusive prefix
  if (warp == 0) {
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) tiles[0] = pack(kInclusive, tile_count);
    } else {
      if (lane == 0) tiles[tile] = pack(kAggregate, tile_count);
      excl = look_back(tiles, tile, lane);
      if (lane == 0) tiles[tile] = pack(kInclusive, excl + tile_count);
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == ntiles - 1) count[0] = excl + tile_count;
    }
  }
  __syncthreads();
  const int excl = s_excl;  // survivors before this tile

  // the tile's dead entries: one run of the tail, counted from the end
  const int dead = min(kTile, n - base) - tile_count;
  const int lo = n - (base - excl) - dead;
  fill_run(c_keys + lo, dead, INT_MAX);
  fill_run(c_idx + lo, dead, -1);
  for (int r = 0; r < rows; ++r) {
    fill_run(reinterpret_cast<int*>(c_payload + static_cast<size_t>(r) * n) +
                 lo,
             dead, 0);  // the bits of 0.0f
  }

  // survivor s of the tile to excl + s: every lane busy, stores side by
  // side, a group of rows loaded before it is stored
  for (int s = threadIdx.x; s < tile_count; s += kThreads) {
    const int k = s_k[s];
    const int pos = excl + s;
    c_keys[pos] = s_key[s];
    c_idx[pos] = k;
    for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
      float v[kRowGroup];
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) {
        if (r0 + g < rows) {
          v[g] = __ldg(payload + static_cast<size_t>(r0 + g) * n + k);
        }
      }
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g) {
        if (r0 + g < rows) {
          c_payload[static_cast<size_t>(r0 + g) * n + pos] = v[g];
        }
      }
    }
  }
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// entries per tile
int gst_compact_tile() { return kTile; }

// number of 64-bit words of scratch gst_compact needs: the ticket and one
// (status, value) word per tile
int gst_compact_words(int n) { return 1 + tiles_of(n); }

int gst_compact(const int* ends, const float* payload, int rows, int n,
                unsigned long long* words, int* c_keys, float* c_payload,
                int* c_idx, int* count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = tiles_of(n);
  if (ntiles == 0) return 0;
  const cudaError_t err =
      cudaMemsetAsync(words, 0, sizeof(word_t) * (1 + ntiles), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_kernel<<<ntiles, kThreads, 0, s>>>(ends, payload, rows, n, ntiles,
                                             words, c_keys, c_payload, c_idx,
                                             count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
