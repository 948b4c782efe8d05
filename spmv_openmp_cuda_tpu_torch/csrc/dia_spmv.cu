// DIA SpMV kernels for Hopper (sm_90a), bound through a plain C interface.
//
// Replace the TPU kernel spmv_openmp_cuda_tpu/ops/spmv_pallas.py::
// dia_spmv_pallas (pallas_call at :426): dia_rows_kernel runs it without a
// fringe (PL_DIA_ROWS, PL_DIA_BF16: the diagonal sum, :345-364);
// dia_resid_kernel runs the whole DIA+residual product (PL_DIA_RESID,
// PL_DIA_RESID_BF16) in one launch, as the TPU kernel does in one
// pallas_call: each row's diagonal sum, then its fringe sum (:365-396)
// added to it.
//
// What bounds them: y = A x over a diagonal slab does 2 flops per stored
// slot and reads 4 B (f32) or 2 B (bf16) of slab per slot, plus x and y
// once; at 2*nnz flops against ~4-6 B/nnz a kernel is bound by slab bytes,
// never by arithmetic. On a large slab the design only has to stream it at
// full bandwidth; on a small one (raefsky1: 1.5 MB, inside L2) the time is
// the launch and a chain of dependent loads, so enough threads must share
// the work that each walks few of them:
//   - dia_rows_kernel: a thread owns R = 4 consecutive output rows (R = 1
//     where four rows a thread would give fewer CTAs than the card has SMs:
//     ops/spmv_cuda.py::rows_a_thread), and adds each row's diagonals in
//     ascending offset order with one FMA each, __fmaf_rn(v, x, acc)
//     (what nvcc contracts acc += v * x into): y is bitwise the same for
//     either R. The slab's row stride is s_pad * 128, a multiple of 4, so
//     each diagonal's four values are one 16-byte (f32) or 8-byte (bf16)
//     load, streamed past L1 (slab_rows.cuh) while x, read through the
//     read-only path, stays in L1 for the neighbouring diagonals; a
//     thread's four x values come from one or two aligned 16-byte vectors
//     (x_quad; one by one at x's ends), so a warp's x reads are four to
//     eight L1 wavefronts a diagonal instead of sixteen; one per-diagonal
//     pointer steps by the stride. Only the m live rows are
//     walked and written (y has m rows), whatever the TPU plan's block
//     height;
//   - dia_resid_kernel: a row's diagonals are split over `groups` threads
//     (1, 2, 4, 8 or 16; ops/spmv_cuda.py::launch_groups doubles it while
//     the grid has fewer CTAs than the card has SMs), so raefsky1's 3242
//     rows run as 203 CTAs of 16 rows x 16 groups of ~6 diagonals, and a
//     200,000-row slab as one thread per row (dia_rows_kernel's
//     streaming). A warp reads >= 16 consecutive rows of a diagonal: whole
//     32-byte sectors. The groups' sums meet in shared memory and the row's
//     group-0 thread adds them in group order: no atomics, a rerun is
//     bitwise equal;
//   - the fringe as per-row lists (ops/spmv_cuda.py::fringe_lists), built
//     once on the host from the TPU layout (slot rows of 128 lanes per TPU
//     block): row i's entries (value, x column) in ascending slot row k, the
//     TPU kernel's order. The row's last-group thread walks its own list
//     (raefsky1: 457 entries over 3242 rows), so no thread walks a TPU
//     block's slot grid and no CTA is bound to a TPU block;
//   - the offsets are a device int32 array read by every thread of a warp
//     at the same address (a broadcast), so one compiled kernel serves
//     every matrix;
//   - x is read straight from the caller's vector: the padded x window of
//     the TPU kernel becomes a bounds test (0 outside [0, n)), and the
//     bf16 modes round x to bf16 (for the fringe too) as the TPU path does
//     before it upcasts. (The TPU window also clips x at (S + pad_sub) *
//     128, which drops fringe products of wide matrices; this bound does
//     not.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_rows.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kMaxGroups = 16;  // threads per row in dia_resid_kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x[col] as the kernels read it: 0 outside [0, n_x) (the zero padding of
// the TPU kernel's window), rounded to bf16 when the slab is bf16. n_x is
// the length of x.
__device__ __forceinline__ float x_at(const float* __restrict__ x, long long col,
                                      long long n_x, bool round_bf16) {
  if (col < 0 || col >= n_x) return 0.f;
  float v = __ldg(x + col);
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// x[col .. col+3], each as x_at reads it. Where the four lie inside x and x
// is 16-byte aligned they come from the aligned float4 vectors that hold
// them: one where col is a multiple of 4, else two (col % 4 is the same for
// every thread of a warp, whose first rows are multiples of 4, so the warp
// takes one branch); else one by one.
__device__ __forceinline__ void x_quad(const float* __restrict__ x, long long col, long long n_x,
                                       bool x16, bool round_bf16, float (&v)[4]) {
  const long long a = col & ~3LL;
  const int s = (int)(col & 3);
  if (x16 && a >= 0 && a + (s ? 8 : 4) <= n_x) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(x + a));
    const float4 q = s ? __ldg(reinterpret_cast<const float4*>(x + a + 4)) : p;
    const float w[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    switch (s) {  // constant indices: w stays in registers
      case 0: v[0] = w[0]; v[1] = w[1]; v[2] = w[2]; v[3] = w[3]; break;
      case 1: v[0] = w[1]; v[1] = w[2]; v[2] = w[3]; v[3] = w[4]; break;
      case 2: v[0] = w[2]; v[1] = w[3]; v[2] = w[4]; v[3] = w[5]; break;
      default: v[0] = w[3]; v[1] = w[4]; v[2] = w[5]; v[3] = w[6]; break;
    }
    if (round_bf16) {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = __bfloat162float(__float2bfloat16_rn(v[r]));
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = x_at(x, col + r, n_x, round_bf16);
  }
}

// y[i] = sum_d data[d, i] * x[i + offsets[d]] for the R rows i0 .. i0+R-1
// of this thread that are < m, each summed by FMAs in ascending offset order
// from +0; rows is the slab's row stride (s_pad * 128); x16: x is 16-byte
// aligned (x_quad's vector reads)
template <typename T, int R>
__global__ void __launch_bounds__(kRowThreads)
dia_rows_kernel(const T* __restrict__ data, const int* __restrict__ offsets, int n_diag,
                long long rows, long long m, const float* __restrict__ x, long long n_x,
                bool x16, float* __restrict__ y) {
  const long long i0 = ((long long)blockIdx.x * kRowThreads + threadIdx.x) * R;
  if (i0 >= m) return;
  constexpr bool kBf16 = sizeof(T) == 2;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const T* p = data + i0;
#pragma unroll 4
  for (int d = 0; d < n_diag; ++d, p += rows) {
    float v[R];
    slab::rows<R>(p, v);
    const long long col = i0 + __ldg(offsets + d);
    float xv[R];
    if constexpr (R == 4)
      x_quad(x, col, n_x, x16, kBf16, xv);
    else
      xv[0] = x_at(x, col, n_x, kBf16);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(v[r], xv[r], acc[r]);
  }
  if constexpr (R == 4) {
    if (i0 + 4 <= m) {
      *reinterpret_cast<float4*>(y + i0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r < m) y[i0 + r] = acc[r];
}

template <typename T>
void launch_rows(const void* data, const int* offsets, int n_diag, long long rows, long long m,
                 const float* x, long long n_x, float* y, int rows_a_thread, cudaStream_t st) {
  const long long threads = (m + rows_a_thread - 1) / rows_a_thread;
  const unsigned grid = (unsigned)((threads + kRowThreads - 1) / kRowThreads);
  const bool x16 = ((uintptr_t)x & 15) == 0;
  if (rows_a_thread == 4)
    dia_rows_kernel<T, 4><<<grid, kRowThreads, 0, st>>>((const T*)data, offsets, n_diag, rows, m,
                                                         x, n_x, x16, y);
  else
    dia_rows_kernel<T, 1><<<grid, kRowThreads, 0, st>>>((const T*)data, offsets, n_diag, rows, m,
                                                         x, n_x, x16, y);
}

// The fringe sum of row i: its list's products added in list order
// (ascending slot row k), from 0.
__device__ __forceinline__ float fringe_sum(const int* __restrict__ row_ptr,
                                            const float* __restrict__ fval,
                                            const int* __restrict__ fcol, long long i,
                                            const float* __restrict__ x, long long n_x,
                                            bool round_bf16) {
  float f = 0.f;
  const int e1 = __ldg(row_ptr + i + 1);
  for (int e = __ldg(row_ptr + i); e < e1; ++e)
    f += __ldg(fval + e) * x_at(x, __ldg(fcol + e), n_x, round_bf16);
  return f;
}

// y[i] = (diagonal sum of row i) + (fringe sum of row i) for i < m. Thread
// t of a CTA takes row r = t % R of the CTA's R = kRowThreads / groups rows
// and the diagonals [g*D/groups, (g+1)*D/groups) of group g = t / R; the
// last group also walks the row's fringe list. Group 0 adds the groups'
// sums in group order, then the fringe sum.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
dia_resid_kernel(const T* __restrict__ data, const int* __restrict__ offsets, int n_diag,
                 long long rows, long long m, const int* __restrict__ row_ptr,
                 const float* __restrict__ fval, const int* __restrict__ fcol,
                 const float* __restrict__ x, long long n_x, int groups,
                 float* __restrict__ y) {
  __shared__ float part[kRowThreads];  // part[g * R + r]: group g's sum of row r
  __shared__ float fring[kRowThreads];
  constexpr bool kBf16 = sizeof(T) == 2;
  const int R = kRowThreads / groups;
  const int r = threadIdx.x % R, g = threadIdx.x / R;
  const long long i = (long long)blockIdx.x * R + r;
  const bool live = i < m;
  float acc = 0.f;
  if (live) {
    const int d1 = (g + 1) * n_diag / groups;
#pragma unroll 8
    for (int d = g * n_diag / groups; d < d1; ++d)
      acc += to_f32(data[(long long)d * rows + i]) * x_at(x, i + __ldg(offsets + d), n_x, kBf16);
  }
  part[threadIdx.x] = acc;
  if (g == groups - 1 && live) fring[r] = fringe_sum(row_ptr, fval, fcol, i, x, n_x, kBf16);
  __syncthreads();
  if (g == 0 && live) {
    float s = part[r];
    for (int h = 1; h < groups; ++h) s += part[h * R + r];
    y[i] = s + fring[r];
  }
}

}  // namespace

extern "C" {

// y[i] = sum_d data[d, i] * x[i + offsets[d]] for i < m (y has m rows);
// data is (n_diag, rows) in f32 (data_bf16 == 0) or bf16 (data_bf16 == 1),
// rows >= m a multiple of 4, data and y 16-byte aligned; rows_a_thread is 1
// or 4 (ops/spmv_cuda.py::rows_a_thread). Returns cudaErrorInvalidValue
// for anything else, else cudaGetLastError() after the launch.
int dia_spmv_launch(int data_bf16, const void* data, const int* offsets, int n_diag,
                    long long rows, long long m, const float* x, long long n_x, float* y,
                    int rows_a_thread, void* stream) {
  if ((rows_a_thread != 1 && rows_a_thread != 4) || m < 1 || m > rows || rows % 4 ||
      (((uintptr_t)data | (uintptr_t)y) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (data_bf16)
    launch_rows<__nv_bfloat16>(data, offsets, n_diag, rows, m, x, n_x, y, rows_a_thread, st);
  else
    launch_rows<float>(data, offsets, n_diag, rows, m, x, n_x, y, rows_a_thread, st);
  return (int)cudaGetLastError();
}

// y[i] = sum_d data[d, i] * x[i + offsets[d]] + the fringe sum of row i,
// for i < m: data is (n_diag, rows) in f32 (data_bf16 == 0) or bf16 (1, x
// then rounded to bf16 for both parts); row i's fringe entries (fval, fcol)
// are row_ptr[i] .. row_ptr[i + 1] - 1. groups (threads per row) is 1, 2,
// 4, 8 or 16 (ops/spmv_cuda.py::launch_groups). Returns
// cudaErrorInvalidValue for another groups, else cudaGetLastError() after
// the launch.
int dia_resid_launch(int data_bf16, const void* data, const int* offsets, int n_diag,
                     long long rows, long long m, const int* row_ptr, const float* fval,
                     const int* fcol, const float* x, long long n_x, float* y, int groups,
                     void* stream) {
  if (groups < 1 || groups > kMaxGroups || (groups & (groups - 1)) || m < 1)
    return (int)cudaErrorInvalidValue;
  const long long per_cta = kRowThreads / groups;
  const unsigned grid = (unsigned)((m + per_cta - 1) / per_cta);
  cudaStream_t st = (cudaStream_t)stream;
  if (data_bf16) {
    dia_resid_kernel<__nv_bfloat16><<<grid, kRowThreads, 0, st>>>(
        (const __nv_bfloat16*)data, offsets, n_diag, rows, m, row_ptr, fval, fcol, x, n_x,
        groups, y);
  } else {
    dia_resid_kernel<float><<<grid, kRowThreads, 0, st>>>(
        (const float*)data, offsets, n_diag, rows, m, row_ptr, fval, fcol, x, n_x, groups, y);
  }
  return (int)cudaGetLastError();
}

const char* dia_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
