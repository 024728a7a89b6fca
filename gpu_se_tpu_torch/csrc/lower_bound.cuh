// Binary search of resample_expand.cu.
#pragma once

namespace gst {

// The first index k in [0, len) with a[k] >= v in the non-decreasing
// a[0, len), or len if there is none: the number of entries < v. One
// thread searches the whole array, ~log2(len) dependent loads; the
// searched arrays of the resample path fit in the H100's 50 MB L2.
template <typename T>
__device__ __forceinline__ int lower_bound(const T* __restrict__ a, int len,
                                           T v) {
  int lo = 0;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = lo + half;
    if (__ldg(a + mid) < v) {
      lo = mid + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

}  // namespace gst
