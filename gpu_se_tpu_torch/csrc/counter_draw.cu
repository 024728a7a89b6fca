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
// integer arithmetic; the floats go through logf, sqrtf and sincosf,
// which round within an ulp or two of the CPU's.
//
// Bound on the H100: memory. It writes 4 (nx + 1) bytes a sample and
// reads the 16-byte key: at the sharded flat step's 2^20 samples a rank
// (nx = 5) 25 MB, 0.0075 ms at 3.35 TB/s. One thread a sample, one
// elementwise pass; the normals go out in the layout the caller asks
// for, (count, nx) rows or (nx, count) lanes-last, so no transpose
// follows. The lanes-last stores are coalesced; the row stores of a warp
// cover one contiguous 32 nx-float run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInv24 = 1.0f / 16777216.0f;

struct Block {
  uint32_t v[4];
};

__device__ __forceinline__ Block philox(Block c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.v[0], hi0 = __umulhi(kM0, c.v[0]);
    const uint32_t lo1 = kM1 * c.v[2], hi1 = __umulhi(kM1, c.v[2]);
    c = Block{{hi1 ^ c.v[1] ^ k0, lo1, hi0 ^ c.v[3] ^ k1, lo0}};
  }
  return c;
}

// the Philox blocks of one sample
__host__ __device__ __forceinline__ int blocks_of(int nx) {
  return (2 * ((nx + 1) / 2) + 4) / 4;
}

__global__ void __launch_bounds__(kThreads)
counter_draw_kernel(const long long* __restrict__ key, long long start,
                    int count, int nx, int lanes_last,
                    uint32_t* __restrict__ words, float* __restrict__ eps,
                    float* __restrict__ u) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const uint32_t k0 = static_cast<uint32_t>(__ldg(key));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(key + 1));
  const unsigned long long j = static_cast<unsigned long long>(start) + i;
  const int nb = blocks_of(nx);
  float u1 = 1.0f;
  for (int b = 0; b < nb; ++b) {
    const Block w = philox(
        Block{{static_cast<uint32_t>(j), static_cast<uint32_t>(j >> 32),
               static_cast<uint32_t>(b), 0u}},
        k0, k1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int at = 4 * b + t;  // the word's place in the sample
      if (words != nullptr) {
        words[static_cast<size_t>(i) * 4 * nb + at] = w.v[t];
      }
      const int q = at - 2;      // the pair's first normal, at an even word
      if (at == 0) {
        u[i] = static_cast<float>(w.v[t] >> 8) * kInv24;
      } else if (at % 2 == 1) {
        u1 = static_cast<float>((w.v[t] >> 8) + 1u) * kInv24;
      } else if (q < nx) {
        const float u2 = static_cast<float>(w.v[t] >> 8) * kInv24;
        const float radius = sqrtf(-2.0f * logf(u1));
        float s, c;
        sincosf(kTwoPi * u2, &s, &c);
        eps[lanes_last ? static_cast<size_t>(q) * count + i
                       : static_cast<size_t>(i) * nx + q] = radius * c;
        if (q + 1 < nx) {
          eps[lanes_last ? static_cast<size_t>(q + 1) * count + i
                         : static_cast<size_t>(i) * nx + q + 1] = radius * s;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// the words of one sample: 4 a Philox block
int gst_counter_draw_words(int nx) { return 4 * blocks_of(nx); }

// key (2,) int64 on the device, its low 32 bits each the Philox key;
// samples [start, start + count); eps (count, nx) float32, or (nx, count)
// where lanes_last; u (count,) float32; words, if not null, (count,
// gst_counter_draw_words(nx)) uint32 (the raw Philox output, for tests).
int gst_counter_draw(const long long* key, long long start, int count, int nx,
                     int lanes_last, unsigned int* words, float* eps, float* u,
                     void* stream) {
  if (count > 0) {
    counter_draw_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        key, start, count, nx, lanes_last, words, eps, u);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
