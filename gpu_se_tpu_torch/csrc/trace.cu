// The span recorder's stamp (gpu_se_tpu_torch/trace.py): one thread
// appends (tag, %globaltimer) to the ring of trace_ring.cuh.
//
// Replaces no Pallas kernel: the reference measures its steps from outside
// (the profiler, timers around jitted calls). The port brackets each graphed
// call, eager or captured into a caller's graph, with two stamps on the
// stream it runs on, so the card's own clock dates the call's device work,
// inside conditional nodes too, where the profiler sees no kernel.
//
// Bound on the H100: a 16-byte store and an 8-byte atomic add, nothing worth
// the name at 3.35 TB/s. A stamp costs what any launch costs: the host's
// launch and the card's scheduling of a one-thread block, which the
// benchmark's cost pairs (recorder armed against switched off) measure.

#include "trace_ring.cuh"

namespace {

__global__ void stamp_kernel(unsigned long long* ring,
                             unsigned long long tag) {
  gst_trace::stamp(ring, tag);
}

}  // namespace

extern "C" {

// one stamp of `tag` into `ring` on `stream` (captured, if the stream is
// capturing)
int gst_stamp(void* ring, unsigned long long tag, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), tag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
