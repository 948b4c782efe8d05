// Transposed-ELL SpMV kernel for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel spmv_openmp_cuda_tpu/ops/spmv_pallas.py::
// ell_t_slab_pallas (pallas_call at :78): y[r] = sum_w data[w, r] * x[cols[w, r]]
// over the transposed (W_pad, M_pad) slab, W_pad = ceil(maxRowNZ/8)*8,
// M_pad = ceil(M/128)*128, padding slots holding value 0 and column 0.
//
// What bounds it: 2 flops per slot against 8 B of slab (an f32 value and an
// int32 column) per slot plus x and y, so the slab bytes bound it, never the
// arithmetic (sg_like: 37.1 MB of slabs, ~11 us at 3.35 TB/s). The design
// streams the slab once:
//   - one thread per output row r, looping w over W_pad: a warp reads 32
//     consecutive entries of one slab row (coalesced, rows on the minor
//     axis, as ellTranspose lays them out for the reference's
//     cudaSpMVRowsELL, SpMV_CUDA.cu:79-96);
//   - the x gather that the TPU kernel leaves to XLA outside the call
//     (spmv_pallas.py:71, a second pass over a (W_pad, M_pad) array) is
//     fused: each thread reads x[cols] itself through the read-only path,
//     and a column outside [0, n) reads 0 instead of memory past x;
//   - each row's sum stays in a register and y[r] is written once: no
//     atomics, so a rerun gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ell_t_kernel(const float* __restrict__ data, const int* __restrict__ cols,
             int w_pad, long long m_pad, long long m,
             const float* __restrict__ x, long long n_x,
             float* __restrict__ y) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= m) return;
  float acc = 0.f;
#pragma unroll 8
  for (int w = 0; w < w_pad; ++w) {
    const long long s = (long long)w * m_pad + r;
    const int c = __ldg(cols + s);
    const float xv = (c >= 0 && c < n_x) ? __ldg(x + c) : 0.f;
    acc += __ldg(data + s) * xv;
  }
  y[r] = acc;
}

}  // namespace

extern "C" {

// y[r] = sum_{w < w_pad} data[w*m_pad + r] * x[cols[w*m_pad + r]] for r < m.
// Returns cudaGetLastError() after the launch.
int ell_t_launch(const float* data, const int* cols, int w_pad,
                 long long m_pad, long long m, const float* x, long long n_x,
                 float* y, void* stream) {
  if (m <= 0) return 0;
  const unsigned grid = (unsigned)((m + kThreads - 1) / kThreads);
  ell_t_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      data, cols, w_pad, m_pad, m, x, n_x, y);
  return (int)cudaGetLastError();
}

const char* ell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
