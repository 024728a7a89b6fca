// The merge path of sorted keys against sorted slot targets, one block's
// share at a time: the device routine of ends_merge_round
// (resample_block.cu) and cumsum_merge (resample_merge.cu), which replace
// the Pallas TPU kernels of gpu_se_tpu/ops/resample_pallas_block.py (:42,
// :231), resample_pallas3.py:43 and resample_pallas.py:35. Both are
// bounded by memory on the H100 (~44 and ~31 MB at 2^20, 5 columns: see
// their notes); the keys are 4 of those MB, and here each key is read
// once, coalesced, where one thread per slot made ~20 dependent loads.
//
// Both kernels count, for every output slot s, c_s = #{k : keys[k] <
// target(s)}, with keys and targets both non-decreasing: A has the int32
// `ends` against slot0 + s, B the float32 normalized cumsum against
// (s + r) / n. That is one merge. Put the keys and the slots in one
// sequence where a key goes before a slot iff key < target (lower_bound's
// predicate, so at a tie the slot goes first and c_s is
// searchsorted(..., right=False)); then c_s is the number of keys before
// slot s, and the first d items of the sequence hold split(d) keys and
// d - split(d) slots.
//
// Block b takes the items [b D, (b + 1) D), D = kMergeThreads x Items
// (each kernel picks its Items), whatever mix of keys and slots they
// are: the keys repeat (dead particles are runs of equal `ends`), so a
// window of slots says nothing of how many keys lie under it, but a
// diagonal of the merge balances both exactly.
// * One warp finds split(b D) and another split((b + 1) D) by a 32-ary
//   search along the diagonal: 32 probes and a ballot a round, 4 rounds
//   over 2^20 keys, in device memory (L2).
// * The block's key segment, at most D keys from an arbitrary start, goes
//   to shared memory by cp.async at the source's misalignment
//   (stage_async). A 1-d TMA bulk copy would need a 16-byte aligned
//   start and length, so cp.async stays.
// * Each thread takes Items consecutive items of the block's
//   diagonal: a binary search in shared memory for its own split, then a
//   serial walk that writes each of its slots' counts to shared memory.
//   No thread searches device memory, no block waits on another: no
//   atomics, no look-back.
// The kernels' epilogues then read the counts in slot order and do their
// own coalesced stores (B's is gather_store).
//
// coarse_gather (resample_coarse.cu) knows its blocks' splits from its
// chunk boundaries and needs no diagonal search: it stages its own
// segments and takes merge_walk and gather_store alone.
#pragma once

#include <cuda_pipeline_primitives.h>

#include <cstddef>

#include "warp_stage.cuh"

namespace gst {

constexpr int kMergeThreads = 256;

// One block's shared memory when each thread walks Items merged items:
// its key segment (shifted by up to 3 for the copy's alignment) and the
// count of each of its slots.
template <int Items, typename Key>
struct MergeShared {
  static constexpr int kBlock = kMergeThreads * Items;  // D
  alignas(16) Key keys[kBlock + 4];
  int counts[kBlock];
  int split[2];
};

// The block's slots [j0, j1), their counts in MergeShared::counts[s - j0].
struct MergeSlots {
  int j0;
  int j1;
};

// split(d): the keys among the first d items of the merge of keys[0,
// n_keys) with the slots [0, n_slots), by one whole warp. The i-th key
// lies in the first d items iff keys[i] < target(d - 1 - i), which is
// true on a prefix of i in [max(0, d - n_slots), min(d, n_keys)).
template <typename Key, typename Target>
__device__ __forceinline__ int warp_merge_split(const Key* __restrict__ keys,
                                                int n_keys, int n_slots,
                                                int d, const Target& target,
                                                int lane) {
  int lo = max(0, d - n_slots);
  int hi = min(d, n_keys);  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const bool before = p < hi && __ldg(keys + p) < target(d - 1 - p);
    const int cnt = __popc(__ballot_sync(kFull, before));
    hi = min(hi, lo + (cnt + 1) * step - 1);
    lo = min(hi, lo + cnt * step);
  }
  const int p = lo + lane;
  const bool before = p < hi && __ldg(keys + p) < target(d - 1 - p);
  return lo + __popc(__ballot_sync(kFull, before));
}

// One thread's items [dt, end) of a block's merge of the staged keys
// sk[0, nk) with the slots j0 + [0, ns): a binary search in shared memory
// for the thread's own split of the block's diagonal, then a serial walk
// that sets counts[s] = base + #{t < nk : sk[t] < target(j0 + s)} for
// each of its slots.
template <typename Key, typename Target>
__device__ __forceinline__ void merge_walk(const Key* sk, int nk, int ns,
                                           int j0, const Target& target,
                                           int base, int dt, int end,
                                           int* counts) {
  int lo = max(0, dt - ns);
  int hi = min(dt, nk);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] < target(j0 + dt - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ki = lo;       // keys taken
  int sj = dt - lo;  // slots taken
  using T = decltype(target(0));
  T t = sj < ns ? target(j0 + sj) : T();
  for (int item = dt; item < end; ++item) {
    if (sj < ns && !(ki < nk && sk[ki] < t)) {
      counts[sj] = base + ki;
      ++sj;
      if (sj < ns) t = target(j0 + sj);
    } else {
      ++ki;
    }
  }
}

// Block blockIdx.x's share of the merge: for each of its slots s,
// sh.counts[s - j0] = base + #{k : keys[k] < target(s)}. Called by the
// whole block of kMergeThreads, with blockIdx.x * D < n_keys + n_slots;
// ends with a barrier, so the counts are there for every thread.
template <int Items, typename Key, typename Target>
__device__ __forceinline__ MergeSlots merge_block(
    const Key* __restrict__ keys, int n_keys, int n_slots,
    const Target& target, int base, MergeShared<Items, Key>& sh) {
  constexpr int kBlock = MergeShared<Items, Key>::kBlock;
  const int d0 = blockIdx.x * kBlock;
  const int d1 = min(d0 + kBlock, n_keys + n_slots);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int i = warp_merge_split(keys, n_keys, n_slots, warp ? d1 : d0,
                                   target, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) sh.split[warp] = i;
  }
  __syncthreads();
  const int i0 = sh.split[0];
  const int nk = sh.split[1] - i0;  // the block's keys [i0, i0 + nk)
  const int j0 = d0 - i0;
  const int ns = d1 - d0 - nk;      // and its slots [j0, j0 + ns)
  const int* src = reinterpret_cast<const int*>(keys + i0);
  const int mis = misalignment(src);
  stage_async(reinterpret_cast<int*>(sh.keys), src, mis, nk);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // this thread's items [dt, dt + Items) of the block's diagonal
  const int nb = nk + ns;
  const int dt = min(static_cast<int>(threadIdx.x) * Items, nb);
  merge_walk(sh.keys + mis, nk, ns, j0, target, base + i0, dt,
             min(dt + Items, nb), sh.counts);
  __syncthreads();
  return {j0, j0 + ns};
}

// [q0, q1): the whole 16-byte quads of slots inside [j0, j1), where the
// arrays written by quads are 16-byte aligned at slot 0 (`wide`); else an
// empty range at j1. The slots [j0, q0) and [q1, j1) go one at a time.
__device__ __forceinline__ void aligned_quads(int j0, int j1, bool wide,
                                              int& q0, int& q1) {
  q0 = j1;
  q1 = j1;
  if (wide) {
    q0 = min((j0 + 3) & ~3, j1);
    q1 = max(q0, j1 & ~3);
  }
}

// The epilogue of cumsum_merge and coarse_gather, by the whole block:
// for each slot i in [j0, j1), with c = cnt[i - j0] in shared memory,
// anc[i] = min(c, n - 1) and out[:, i] = payload[:, anc[i]], payload and
// out (rows, n) row-major. Each thread takes an aligned quad of slots,
// loads all its rows in groups of kGatherRows first, then stores a float4
// a row and an int4 of ancestors; scalar stores at the ragged ends and
// wherever n % 4 != 0, since row k starts at out + k n.
constexpr int kGatherRows = 8;

__device__ __forceinline__ void gather_store(const int* cnt, int j0, int j1,
                                             const float* __restrict__ payload,
                                             int rows, int n,
                                             float* __restrict__ out,
                                             int* __restrict__ anc) {
  auto ancestor = [&](int i) { return min(cnt[i - j0], n - 1); };
  int q0, q1;
  aligned_quads(j0, j1, (n & 3) == 0, q0, q1);
  for (int q = threadIdx.x; q < (q1 - q0) >> 2; q += blockDim.x) {
    const int i = q0 + 4 * q;
    const int a[4] = {ancestor(i), ancestor(i + 1), ancestor(i + 2),
                      ancestor(i + 3)};
    *reinterpret_cast<int4*>(anc + i) = make_int4(a[0], a[1], a[2], a[3]);
    for (int k0 = 0; k0 < rows; k0 += kGatherRows) {
      float v[kGatherRows][4];
#pragma unroll
      for (int g = 0; g < kGatherRows; ++g) {
        if (k0 + g < rows) {
          const float* row = payload + static_cast<size_t>(k0 + g) * n;
#pragma unroll
          for (int u = 0; u < 4; ++u) v[g][u] = __ldg(row + a[u]);
        }
      }
#pragma unroll
      for (int g = 0; g < kGatherRows; ++g) {
        if (k0 + g < rows) {
          *reinterpret_cast<float4*>(out + static_cast<size_t>(k0 + g) * n +
                                     i) =
              make_float4(v[g][0], v[g][1], v[g][2], v[g][3]);
        }
      }
    }
  }
  const int n_head = q0 - j0;
  for (int t = threadIdx.x; t < n_head + (j1 - q1); t += blockDim.x) {
    const int i = t < n_head ? j0 + t : q1 + (t - n_head);
    const int a = ancestor(i);
    anc[i] = a;
    for (int k = 0; k < rows; ++k) {
      out[static_cast<size_t>(k) * n + i] =
          __ldg(payload + static_cast<size_t>(k) * n + a);
    }
  }
}

}  // namespace gst
