// Gaussian-sum density of a batch of residual rows for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's GaussianSum.pdf is an XLA einsum
// (gpu_se_tpu/distributions/gaussian_sum.py:156). The port's einsum of the
// same form went to cuBLAS's batched gemv, one dot product of length ny
// for each of the n Nd (row, component) pairs, after a permuting copy of
// the (n, Nd, ny) differences, with six elementwise kernels after it.
//
// Row k of x (n rows of ny floats, read through the strides given: the
// filters' residual z - g(x.T).T is a column-major view, read where it
// lies) gives, with e = x_k - mean_d,
//   q_d    = sum_i e_i (sum_j inv_cov[d, j, i] e_j)
//   pdf    = sum_d w_d expf(log_const_d - 0.5 q_d)              (d in order)
//   logpdf = logsumexp_d(log_const_d - 0.5 q_d + log w_d)       (LOG mode)
// GaussianSum.pdf_t's order (the reference's (e @ inv_cov) . e), each
// product, sum and difference rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc contracts none of them into an FMA), expf and logf, no
// fast math: the kernel gives pdf_t's bits on the card. logsumexp is
// torch's: m the largest term (0 where it is infinite), log(sum_d exp(l_d
// - m)) + m. With a scale, out_k = scale_k pdf_k: the filters' prior
// weight times the density, one rounding as the separate multiply had.
//
// Bound on the H100 at the main paths' 2^20 rows (Nd = ny = 2): 8 bytes of
// residual and 4 of prior weight read and 4 written a row, 16.8 MB, 5.0 us
// at 3.35 TB/s; 30 float32 operations a row, 0.5 us at 67 TFLOP/s. The
// flat state fits in the 50 MB L2, so a launch may beat the HBM bound.
// How the design meets it:
// 1. one thread a row (a grid-stride loop past kMaxBlocks blocks): each
//    column of the column-major residual, the prior weights and the output
//    move as coalesced runs, and nothing between the read and the write
//    leaves the registers;
// 2. the mixture's Nd (ny + ny^2 + 2) floats are staged once a block in
//    shared memory from device pointers (a CUDA graph captures the launch;
//    the values are read at each replay), Nd and ny at run time: one
//    kernel a mode serves every shape, each difference recomputed (the
//    same bits) where it is needed rather than held in an array. At the
//    main paths' Nd = ny = 2 the row's few reloads hit L1, so the launch
//    stays bound by the rows' bytes.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;      // a block's threads, one row each
constexpr int kMaxBlocks = 65536;  // past 2^24 rows a thread takes more
constexpr int kMaxShared = 48 * 1024;  // dynamic shared memory, bytes

struct Rows {
  const float* x;      // row k, column j at x[k s_row + j s_col]
  long long n, s_row, s_col;
  const float* scale;  // null, or scale_k at scale[k s_scale]
  long long s_scale;
  float* out;          // (n,), contiguous
};

struct Mixture {
  const float* means;      // (nd, ny)
  const float* inv_cov;    // (nd, ny, ny)
  const float* log_const;  // (nd,)
  const float* weights;    // (nd,)
};

__host__ __device__ constexpr int mixture_floats(int nd, int ny) {
  return nd * (ny + ny * ny + 2);
}

// the block's copy of the mixture: means, inv_cov, log_const, then the
// weights, or their logs in LOG mode
__device__ __forceinline__ void stage(float* sm, const Mixture& m, int nd,
                                      int ny, bool log_w) {
  const int nm = nd * ny, nc = nd * ny * ny;
  for (int k = threadIdx.x; k < mixture_floats(nd, ny); k += blockDim.x) {
    float v;
    if (k < nm) {
      v = m.means[k];
    } else if (k < nm + nc) {
      v = m.inv_cov[k - nm];
    } else if (k < nm + nc + nd) {
      v = m.log_const[k - nm - nc];
    } else {
      v = m.weights[k - nm - nc - nd];
      if (log_w) v = logf(v);
    }
    sm[k] = v;
  }
  __syncthreads();
}

// torch.logsumexp of the terms l[0 .. nd): the largest term, 0 where it
// is infinite, out of the exponentials and back after the log
__device__ __forceinline__ float largest_or_zero(float m) {
  return fabsf(m) == INFINITY ? 0.0f : m;
}

// log_const_d - 0.5 q_d of row xk: pdf_t's order
__device__ __forceinline__ float component_arg(const float* xk, long long s_col,
                                               const float* mean,
                                               const float* icov, float lc,
                                               int ny) {
  float q = 0.0f;
  for (int i = 0; i < ny; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < ny; ++j) {
      const float ej = __fsub_rn(__ldg(xk + j * s_col), mean[j]);
      const float t = __fmul_rn(icov[j * ny + i], ej);
      acc = j == 0 ? t : __fadd_rn(acc, t);
    }
    const float t = __fmul_rn(__fsub_rn(__ldg(xk + i * s_col), mean[i]), acc);
    q = i == 0 ? t : __fadd_rn(q, t);
  }
  return __fsub_rn(lc, __fmul_rn(0.5f, q));
}

template <bool kLog>
__global__ void __launch_bounds__(kThreads)
mixture_rows(Rows r, Mixture m, int nd, int ny) {
  extern __shared__ float sm[];
  stage(sm, m, nd, ny, kLog);
  const float* mean = sm;
  const float* icov = mean + nd * ny;
  const float* lc = icov + nd * ny * ny;
  const float* w = lc + nd;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       k < r.n; k += stride) {
    const float* xk = r.x + k * r.s_row;
    float v = 0.0f;
    if constexpr (kLog) {
      // two passes over the components, each term computed anew (the
      // same bits): the largest, then the sum
      float mx = 0.0f;
      for (int d = 0; d < nd; ++d) {
        const float l = __fadd_rn(
            component_arg(xk, r.s_col, mean + d * ny, icov + d * ny * ny,
                          lc[d], ny),
            w[d]);
        mx = d == 0 ? l : fmaxf(mx, l);
      }
      mx = largest_or_zero(mx);
      float s = 0.0f;
      for (int d = 0; d < nd; ++d) {
        const float l = __fadd_rn(
            component_arg(xk, r.s_col, mean + d * ny, icov + d * ny * ny,
                          lc[d], ny),
            w[d]);
        const float t = expf(__fsub_rn(l, mx));
        s = d == 0 ? t : __fadd_rn(s, t);
      }
      v = __fadd_rn(logf(s), mx);
    } else {
      for (int d = 0; d < nd; ++d) {
        const float c = __fmul_rn(
            w[d], expf(component_arg(xk, r.s_col, mean + d * ny,
                                     icov + d * ny * ny, lc[d], ny)));
        v = d == 0 ? c : __fadd_rn(v, c);
      }
      if (r.scale != nullptr) v = __fmul_rn(__ldg(r.scale + k * r.s_scale), v);
    }
    r.out[k] = v;
  }
}

}  // namespace

extern "C" {

// x: n rows of ny float32, row k column j at x[k s_row + j s_col];
// the mixture's means (nd, ny), inv_cov (nd, ny, ny), log_const (nd,),
// weights (nd,), float32, contiguous, on the device; scale: null, or n
// float32 at stride s_scale (refused in LOG mode); out (n,) float32.
// Refused: a mixture over kMaxShared bytes.
int gst_mixture_pdf(const float* x, long long n, long long s_row,
                    long long s_col, int nd, int ny, const float* means,
                    const float* inv_cov, const float* log_const,
                    const float* weights, const float* scale,
                    long long s_scale, int log_mode, float* out,
                    void* stream) {
  const long long bytes = static_cast<long long>(sizeof(float)) * nd *
                          (ny + static_cast<long long>(ny) * ny + 2);
  if (nd < 1 || ny < 1 || n < 0 || (log_mode && scale != nullptr) ||
      bytes > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      blocks < kMaxBlocks ? blocks : kMaxBlocks);
  const Rows r{x, n, s_row, s_col, scale, s_scale, out};
  const Mixture m{means, inv_cov, log_const, weights};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (log_mode) {
    mixture_rows<true><<<grid, kThreads, bytes, st>>>(r, m, nd, ny);
  } else {
    mixture_rows<false><<<grid, kThreads, bytes, st>>>(r, m, nd, ny);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
