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
// arithmetic. The design reads little more than the slots the rows hold:
//   - a thread takes four consecutive output rows r .. r + 3 and reads, for
//     each w, their four entries of slab row w with one 16-byte load of data
//     and one of cols (rows on the minor axis, as ellTranspose lays them out
//     for the reference's cudaSpMVRowsELL, SpMV_CUDA.cu:79-96): a warp reads
//     512 consecutive bytes of each;
//   - a thread walks w only up to the longest of its four rows, read from
//     the walk table (walk[r / kGroupRows], made once per layout by
//     ops/ell_cuda.py from row_lens), not up to W_pad; a warp runs until its
//     longest row, its other threads issuing no loads. On sg_like (rows of
//     6-26 entries, W_pad 32) that reads 20.2 MB of the 37.1 MB slab, on
//     thermal2_like 83.1 of 157.2 MB. The slots it skips hold value 0
//     (ops/ell_cuda.py checks it at a layout's first launch), so a padding
//     slot no longer reads x[0];
//   - a thread issues the slab loads of the next kBatch slab rows before the
//     x gathers and adds of this batch, so 2 * kBatch loads of 16 bytes of
//     each array are in flight;
//   - the x gather that the TPU kernel leaves to XLA outside the call
//     (spmv_pallas.py:71, a second pass over a (W_pad, M_pad) array) is
//     fused: each thread reads x[cols] itself through the read-only path,
//     and a column outside [0, n) reads 0 instead of memory past x;
//   - a row's terms are added w ascending from +0, one FMA each
//     (__fmaf_rn: the product rounded once with the add), the order and
//     arithmetic of the full-width walk, whose extra terms are +0 * x[0]:
//     for finite x, y is that walk's (ops/ell_cuda.py::ell_t_in_order);
//   - each row's sum stays in a register and y[r] is written once: no
//     atomics, so a rerun gives the same bits.
// Measured on an H100 (scripts/torch_ell_probe.py, PERF.md), graphed on
// thermal2_like: this layout 0.0398 ms; a walk table per warp (128 rows)
// 0.0424; a thread per row with 4-byte loads 0.0497 (a table per warp of 32
// rows) and 0.0507 (each thread to its own row: the nonzero slots alone),
// so it is not the bytes that held that layout back; the full width 0.0580.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // rows of y a thread takes: 16-byte loads of data and cols
constexpr int kGroupRows = 4;      // rows per entry of the walk table: one thread's
constexpr int kBatch = 4;          // slab rows whose loads a thread issues together

__device__ __forceinline__ float x_at(const float* __restrict__ x, int c, long long n_x) {
  return (c >= 0 && c < n_x) ? __ldg(x + c) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
ell_t_kernel(const float* __restrict__ data, const int* __restrict__ cols,
             const int* __restrict__ walk, long long m_pad, long long m,
             const float* __restrict__ x, long long n_x, float* __restrict__ y) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) * kRowsPerThread;
  if (r >= m) return;
  const int len = __ldg(walk + r / kGroupRows);
  float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float4 d[kBatch];
  int4 c[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    d[u] = u < len ? __ldg(reinterpret_cast<const float4*>(data + (long long)u * m_pad + r))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    c[u] = u < len ? __ldg(reinterpret_cast<const int4*>(cols + (long long)u * m_pad + r))
                   : make_int4(-1, -1, -1, -1);
  }
  for (int w0 = 0; w0 < len; w0 += kBatch) {
    float4 dv[kBatch], xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      xv[u] = make_float4(x_at(x, c[u].x, n_x), x_at(x, c[u].y, n_x), x_at(x, c[u].z, n_x),
                          x_at(x, c[u].w, n_x));
      dv[u] = d[u];
    }
    // the next batch's slab loads, in flight while this batch is added
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int w = w0 + kBatch + u;
      d[u] = w < len ? __ldg(reinterpret_cast<const float4*>(data + (long long)w * m_pad + r))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      c[u] = w < len ? __ldg(reinterpret_cast<const int4*>(cols + (long long)w * m_pad + r))
                     : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (w0 + u < len) {
        acc[0] = __fmaf_rn(dv[u].x, xv[u].x, acc[0]);
        acc[1] = __fmaf_rn(dv[u].y, xv[u].y, acc[1]);
        acc[2] = __fmaf_rn(dv[u].z, xv[u].z, acc[2]);
        acc[3] = __fmaf_rn(dv[u].w, xv[u].w, acc[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    if (r + i < m) y[r + i] = acc[i];
}

}  // namespace

extern "C" {

// y[r] = sum_{w < walk[r / kGroupRows]} data[w*m_pad + r] * x[cols[w*m_pad +
// r]] for r < m; walk holds ceil(m / kGroupRows) entries, each at most the
// slab's W_pad; data and cols 16-byte aligned, m_pad a multiple of 4.
// Returns cudaGetLastError() after the launch.
int ell_t_launch(const float* data, const int* cols, const int* walk, long long m_pad,
                 long long m, const float* x, long long n_x, float* y, void* stream) {
  if (m <= 0) return 0;
  constexpr long long kRowsPerCta = (long long)kThreads * kRowsPerThread;
  const unsigned grid = (unsigned)((m + kRowsPerCta - 1) / kRowsPerCta);
  ell_t_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(data, cols, walk, m_pad, m, x, n_x,
                                                            y);
  return (int)cudaGetLastError();
}

const char* ell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
