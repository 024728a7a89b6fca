// Counter-based noise draw for Hopper (sm_90a): Philox4x32-10 (Salmon,
// Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1, 2, 3",
// SC 2011), written out here; no curand header.
//
// Replaces no Pallas kernel. It is the port's counterpart of the
// reference's partitionable threefry draw outside its shard_map
// (gpu_se_tpu/parallel/sharded.py:1015-1017 and :1133-1135): sample j of
// a step's noise depends only on the step's key and on j, so each rank
// writes only the samples [start, start + count) of its own slice, and
// any split of [0, n) into slices concatenates to the whole draw.
//
// Sample j takes the Philox blocks (j mod 2^32, j div 2^32, b, 0) under
// the key (k0, k1) for b = 0 .. nb - 1, four 32-bit words each, read in
// order as w[0], w[1], ...:
//   u      = (w[0] >> 8) 2^-24                 in [0, 1), exact in float32
//   u1     = ((w[1 + 2q] >> 8) + 1) 2^-24      in (0, 1]
//   u2     = (w[2 + 2q] >> 8) 2^-24            in [0, 1)
//   z[2q]     = sqrt(-2 log u1) cos(2 pi u2)   Box-Muller, float32
//   z[2q + 1] = sqrt(-2 log u1) sin(2 pi u2)   (dropped past nx)
// with nb = ceil((1 + 2 ceil(nx / 2)) / 4) blocks. The words are exact
// integer arithmetic; the floats go through logf, sqrtf and sincospif
// (of 2 u2, exact), which the plain version's float32 log, sqrt and
// sin/cos of the rounded angle float32(2 pi) u2 meet within 4.2e-6 at
// the largest radius, 5.77 (ops/counter_draw.NORMAL_ATOL is 8e-6).
//
// Bound on the H100: the issue rate, above the bytes. Bytes: 4 (nx + 1)
// a sample written and the 16-byte key read, at the sharded flat step's
// 2^20 samples a rank (nx = 5) 25 MB, 0.0075 ms at 3.35 TB/s. Issue:
// draw_fixed<5> issues at least 1367 SASS instructions a warp (4 x 32
// samples) before its first store, the two Philox blocks and three
// Box-Muller pairs of each sample, so 2^20 samples take at least 0.0107
// ms on 132 SMs issuing 4 a cycle at 1980 MHz, and half of them are
// integer or compare instructions that issue at half that rate
// (`python -m gpu_se_tpu_torch.results.counter_draw_study` reads the
// SASS and times each design choice below; PERF.md keeps the readings).
// What the design does about the first design's five costs:
// 1. unrolled: the kernel is a template on NX, instantiated for nx = 1
//    .. 5 (5 on every main path); the word loop unrolls, its branches
//    fold, and each pair's u1, u2 come from known registers. Any other
//    nx takes draw_any, the same sample loop with nx at run time;
// 2. no test hook: the words of the tests come from a kernel of their
//    own (draw_words, gst_counter_words), and the draw takes no words
//    pointer and tests none;
// 3. coalesced stores: rows are staged per block in shared memory (each
//    thread's kSamples x NX normals as 16-byte stores) and leave as one
//    contiguous run of 16-byte stores; lanes-last rows take one float4
//    a thread and row, the uniforms one float4 a thread; the ragged
//    tail is masked, and start only moves the counters, so an unaligned
//    start changes no address;
// 4. sincospif(2 u2) has no range reduction, so no Payne-Hanek path and
//    no local-memory frame (no fast-math: __logf's absolute error near
//    u1 = 1 exceeds -log u1);
// 5. each thread draws kSamples consecutive samples, kSamples x nb
//    independent Philox chains in flight, under round keys computed once
//    a thread.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // a block's threads
constexpr int kSamples = 4;     // consecutive samples a thread
constexpr int kTile = kThreads * kSamples;  // samples a block
constexpr int kRounds = 10;
constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr float kInv24 = 1.0f / 16777216.0f;

static_assert(kSamples == 2 || kSamples == 4, "a float2 or float4 a run");

// the Philox blocks of one sample
__host__ __device__ constexpr int blocks_of(int nx) {
  return (2 * ((nx + 1) / 2) + 4) / 4;
}

struct RoundKeys {
  uint32_t k0[kRounds], k1[kRounds];
};

__device__ __forceinline__ RoundKeys round_keys(const long long* key) {
  RoundKeys rk;
  rk.k0[0] = static_cast<uint32_t>(__ldg(key));
  rk.k1[0] = static_cast<uint32_t>(__ldg(key + 1));
#pragma unroll
  for (int r = 1; r < kRounds; ++r) {
    rk.k0[r] = rk.k0[r - 1] + kW0;
    rk.k1[r] = rk.k1[r - 1] + kW1;
  }
  return rk;
}

// Philox4x32-10 of C independent counters, in place
template <int C>
__device__ __forceinline__ void philox(uint32_t (&c)[C][4],
                                       const RoundKeys& rk) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const uint32_t lo0 = kM0 * c[i][0], hi0 = __umulhi(kM0, c[i][0]);
      const uint32_t lo1 = kM1 * c[i][2], hi1 = __umulhi(kM1, c[i][2]);
      c[i][0] = hi1 ^ c[i][1] ^ rk.k0[r];
      c[i][1] = lo1;
      c[i][2] = hi0 ^ c[i][3] ^ rk.k1[r];
      c[i][3] = lo0;
    }
  }
}

__device__ __forceinline__ void counter(uint32_t (&c)[4],
                                        unsigned long long j, int b) {
  c[0] = static_cast<uint32_t>(j);
  c[1] = static_cast<uint32_t>(j >> 32);
  c[2] = static_cast<uint32_t>(b);
  c[3] = 0u;
}

__device__ __forceinline__ float unit(uint32_t w) {
  return static_cast<float>(w >> 8) * kInv24;
}

// the pair (z[2q], z[2q + 1]) of the words w[1 + 2q], w[2 + 2q]
__device__ __forceinline__ void box_muller(uint32_t w1, uint32_t w2,
                                           float& z0, float& z1) {
  const float u1 = static_cast<float>((w1 >> 8) + 1u) * kInv24;
  const float radius = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * unit(w2), &s, &c);
  z0 = radius * c;
  z1 = radius * s;
}

// kSamples consecutive floats as one 8- or 16-byte store
__device__ __forceinline__ void store_run(float* dst,
                                          const float (&v)[kSamples]) {
  if constexpr (kSamples == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// kSamples consecutive samples a thread, NX known at compile time
template <int NX, bool kLanesLast>
__global__ void __launch_bounds__(kThreads)
draw_fixed(const long long* __restrict__ key, long long start, int count,
           float* __restrict__ eps, float* __restrict__ u) {
  constexpr int kBlocks = blocks_of(NX);
  constexpr int kPairs = (NX + 1) / 2;
  const long long block0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long first = block0 + threadIdx.x * kSamples;
  const RoundKeys rk = round_keys(key);
  uint32_t c[kSamples * kBlocks][4];
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      counter(c[s * kBlocks + b],
              static_cast<unsigned long long>(start) + first + s, b);
    }
  }
  philox(c, rk);
  // word t of sample s is c[s * kBlocks + t / 4][t % 4]; the last sine
  // of an odd NX is left unused
  float z[kSamples][2 * kPairs], uu[kSamples];
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
    const uint32_t* w = c[s * kBlocks];
    uu[s] = unit(w[0]);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int t = 1 + 2 * p;
      box_muller(c[s * kBlocks + t / 4][t % 4],
                 c[s * kBlocks + (t + 1) / 4][(t + 1) % 4], z[s][2 * p],
                 z[s][2 * p + 1]);
    }
  }
  const long long valid = count - first;  // this thread's samples in range
  if (valid >= kSamples) {
    store_run(u + first, uu);
  } else {
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      if (s < valid) u[first + s] = uu[s];
    }
  }
  if constexpr (kLanesLast) {
#pragma unroll
    for (int q = 0; q < NX; ++q) {
      float v[kSamples];
#pragma unroll
      for (int s = 0; s < kSamples; ++s) v[s] = z[s][q];
      const size_t at = static_cast<size_t>(q) * count + first;
      if (valid >= kSamples && at % kSamples == 0) {
        store_run(eps + at, v);
      } else {
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
          if (s < valid) eps[at + s] = v[s];
        }
      }
    }
  } else {
    // the block's (kTile, NX) rows, one contiguous run of the output
    __shared__ __align__(16) float tile[kTile * NX];
    float* mine = tile + threadIdx.x * kSamples * NX;
    if constexpr (kSamples * NX % 4 == 0) {
#pragma unroll
      for (int k = 0; k < kSamples * NX; k += 4) {
        *reinterpret_cast<float4*>(mine + k) = make_float4(
            z[k / NX][k % NX], z[(k + 1) / NX][(k + 1) % NX],
            z[(k + 2) / NX][(k + 2) % NX], z[(k + 3) / NX][(k + 3) % NX]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSamples * NX; ++k) mine[k] = z[k / NX][k % NX];
    }
    __syncthreads();
    float* out = eps + static_cast<size_t>(block0) * NX;
    const long long here = count - block0;
    if (here >= kTile) {
      // kTile NX floats from a multiple of kTile NX: 16-byte aligned
      const float4* src = reinterpret_cast<const float4*>(tile);
      float4* dst = reinterpret_cast<float4*>(out);
#pragma unroll
      for (int k = threadIdx.x; k < kTile * NX / 4; k += kThreads) {
        dst[k] = src[k];
      }
    } else {
      const int n = static_cast<int>(here) * NX;
      for (int k = threadIdx.x; k < n; k += kThreads) out[k] = tile[k];
    }
  }
}

// kSamples consecutive samples a thread, nx at run time: the blocks of
// the samples in turn, each word used as it comes
template <bool kLanesLast>
__global__ void __launch_bounds__(kThreads)
draw_any(const long long* __restrict__ key, long long start, int count,
         int nx, float* __restrict__ eps, float* __restrict__ u) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kSamples;
  const RoundKeys rk = round_keys(key);
  const int nb = blocks_of(nx);
  uint32_t w1[kSamples];  // each sample's pending u1 word
  for (int b = 0; b < nb; ++b) {
    uint32_t c[kSamples][4];
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      counter(c[s], static_cast<unsigned long long>(start) + first + s, b);
    }
    philox(c, rk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int at = 4 * b + t;  // the word's place in the sample
      const int q = at - 2;      // the pair's first normal, at an even word
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const long long i = first + s;
        if (at % 2 == 1) {
          w1[s] = c[s][t];
        } else if (i < count && at == 0) {
          u[i] = unit(c[s][t]);
        } else if (i < count && q < nx) {
          float z0, z1;
          box_muller(w1[s], c[s][t], z0, z1);
          eps[kLanesLast ? static_cast<size_t>(q) * count + i
                         : static_cast<size_t>(i) * nx + q] = z0;
          if (q + 1 < nx) {
            eps[kLanesLast ? static_cast<size_t>(q + 1) * count + i
                           : static_cast<size_t>(i) * nx + q + 1] = z1;
          }
        }
      }
    }
  }
}

// The verification hook: the raw Philox words of each sample, one thread
// a sample, through the same counters, round keys and philox() as the
// draws. No step calls it.
__global__ void __launch_bounds__(kThreads)
draw_words(const long long* __restrict__ key, long long start, int count,
           int nx, uint32_t* __restrict__ words) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= count) return;
  const RoundKeys rk = round_keys(key);
  const int nb = blocks_of(nx);
  for (int b = 0; b < nb; ++b) {
    uint32_t c[1][4];
    counter(c[0], static_cast<unsigned long long>(start) + i, b);
    philox(c, rk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      words[static_cast<size_t>(i) * 4 * nb + 4 * b + t] = c[0][t];
    }
  }
}

// draw_fixed is instantiated for nx = 1 .. 5, the wrapper's
// ops/counter_draw.MAX_FIXED_NX
template <bool kLanesLast>
int launch(const long long* key, long long start, int count, int nx,
           int fixed_nx, float* eps, float* u, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(count) + kTile - 1) / kTile);
  switch (fixed_nx) {
    case 0:
      draw_any<kLanesLast><<<grid, kThreads, 0, stream>>>(key, start, count,
                                                          nx, eps, u);
      break;
    case 1:
      draw_fixed<1, kLanesLast><<<grid, kThreads, 0, stream>>>(
          key, start, count, eps, u);
      break;
    case 2:
      draw_fixed<2, kLanesLast><<<grid, kThreads, 0, stream>>>(
          key, start, count, eps, u);
      break;
    case 3:
      draw_fixed<3, kLanesLast><<<grid, kThreads, 0, stream>>>(
          key, start, count, eps, u);
      break;
    case 4:
      draw_fixed<4, kLanesLast><<<grid, kThreads, 0, stream>>>(
          key, start, count, eps, u);
      break;
    case 5:
      draw_fixed<5, kLanesLast><<<grid, kThreads, 0, stream>>>(
          key, start, count, eps, u);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the words of one sample: 4 a Philox block
int gst_counter_draw_words(int nx) { return 4 * blocks_of(nx); }

// key (2,) int64 on the device, its low 32 bits each the Philox key;
// samples [start, start + count); fixed_nx the instantiation that draws
// them: nx itself (1 .. 5) or 0, the run-time-nx kernel; any other is
// refused; eps (count, nx) float32, or (nx, count) where
// lanes_last; u (count,) float32
int gst_counter_draw(const long long* key, long long start, int count, int nx,
                     int fixed_nx, int lanes_last, float* eps, float* u,
                     void* stream) {
  if (fixed_nx != 0 && fixed_nx != nx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lanes_last ? launch<true>(key, start, count, nx, fixed_nx, eps, u, st)
                    : launch<false>(key, start, count, nx, fixed_nx, eps, u,
                                    st);
}

// the verification hook: words (count, gst_counter_draw_words(nx)) uint32,
// the raw Philox output of the same samples
int gst_counter_words(const long long* key, long long start, int count,
                      int nx, unsigned int* words, void* stream) {
  if (count > 0) {
    const unsigned grid = static_cast<unsigned>(
        (static_cast<long long>(count) + kThreads - 1) / kThreads);
    draw_words<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        key, start, count, nx, words);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
