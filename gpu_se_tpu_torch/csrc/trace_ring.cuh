// The span recorder's ring on the card (gpu_se_tpu_torch/trace.py), shared
// by the stamp kernel (trace.cu) and the conditional nodes' set kernel
// (graph_cond.cu), which stamps the QP's WHILE iterations.
//
// Layout, 64-bit words: a header of four (the cursor, stamps taken so far,
// advanced by an atomic add; the capacity; the address of a 32-bit flag in
// pinned host memory, or 0; one unused), then `capacity` records of 16
// bytes, (tag, %globaltimer). A stamp lands at record `cursor`; the ring
// does not wrap: a stamp that finds it full is only counted, and the first
// such stamp raises the host's flag, which stops the recorder's eager
// stamps.
//
// Tags: the low two bits are the kind (trace.py's BEGIN 0, END 1, and the
// two written here); the rest names what was stamped.
#pragma once

#include <cuda_runtime.h>

namespace gst_trace {

constexpr unsigned long long kWhile = 2;  // a counted WHILE iteration ended
constexpr unsigned long long kIf = 3;     // a nested IF node was taken

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one record: the time first, then a slot by the atomic cursor, then one
// 16-byte store; past the capacity, the flag once
__device__ __forceinline__ void stamp(unsigned long long* ring,
                                      unsigned long long tag) {
  const unsigned long long t = globaltimer();
  const unsigned long long i = atomicAdd(ring, 1ull);
  if (i < ring[1]) {
    reinterpret_cast<ulonglong2*>(ring)[2 + i] = make_ulonglong2(tag, t);
  } else if (i == ring[1] && ring[2] != 0ull) {
    *reinterpret_cast<volatile unsigned int*>(ring[2]) = 1u;
    __threadfence_system();
  }
}

}  // namespace gst_trace
