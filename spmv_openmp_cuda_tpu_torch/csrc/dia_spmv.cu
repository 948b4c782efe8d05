// DIA SpMV kernels for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernel spmv_openmp_cuda_tpu/ops/spmv_pallas.py::
// dia_spmv_pallas (pallas_call at :426): dia_rows_kernel ports its diagonal
// sum (:345-364), dia_resid_kernel its residual-fringe branch (:365-396).
//
// What bounds it: y = A x over a diagonal slab does 2 flops per stored slot
// and reads 4 B (f32) or 2 B (bf16) of slab per slot, plus x and y once;
// at 2*nnz flops against ~4-6 B/nnz the kernel is bound by slab bytes, never
// by arithmetic. The design therefore only has to stream the slab at full
// bandwidth:
//   - one thread per output row, so a warp reads 32 consecutive slab
//     entries of one diagonal (coalesced) and 32 consecutive x entries
//     (neighbouring diagonals re-read the same x lines, served from L1/L2);
//   - the TPU's VMEM block of bs row groups is not the CUDA block: the grid
//     covers every row with 256-thread blocks, so all SMs stream the slab
//     even when the TPU plan has a single block;
//   - the offsets are a device int32 array read by every thread of a warp
//     at the same address (a broadcast), so one compiled kernel serves
//     every matrix;
//   - x is read straight from the caller's vector: the padded x window of
//     the TPU kernel becomes a bounds test (0 outside [0, n)), and the
//     bf16 modes round x to bf16 as the TPU path does before it upcasts.
//     (The TPU window also clips x at (S + pad_sub) * 128, which drops
//     fringe products of wide matrices; this bound does not.)
// The fringe is a second launch on the same stream: one block per TPU block
// i and one thread per lane l. Every fringe slot (i, k, l) adds into an
// output row of block i at lane l, so thread (i, l) owns those rows, sums
// them in shared memory without atomics, and adds the sums to y after the
// diagonal pass, the order of the TPU kernel (diagonals, then fringe).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kRowThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
dia_rows_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
                int n_diag, long long rows, const float* __restrict__ x,
                long long n_x, float* __restrict__ y) {
  const long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= rows) return;
  constexpr bool kBf16 = sizeof(T) == 2;
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < n_diag; ++d) {
    const long long col = i + __ldg(offsets + d);
    acc += to_f32(data[(long long)d * rows + i]) * x_at(x, col, n_x, kBf16);
  }
  y[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kLane)
dia_resid_kernel(const T* __restrict__ rvals, const int8_t* __restrict__ rsidx,
                 const int8_t* __restrict__ rgid, const int* __restrict__ rsrc,
                 int bs, int k_pad, int n_kt, int pad_sub,
                 const float* __restrict__ x, long long n_x, bool x_bf16,
                 float* __restrict__ y) {
  extern __shared__ float racc[];  // (bs, kLane); column l is thread l's own
  const int blk = blockIdx.x;
  const int l = threadIdx.x;
  for (int g = 0; g < bs; ++g) racc[g * kLane + l] = 0.f;
  const long long slot0 = (long long)blk * k_pad * kLane + l;
  const int* rsrc_blk = rsrc + (long long)blk * n_kt * 8 * kLane;
  // unrolled so the global loads of several slot rows are in flight at
  // once: a single block per TPU block is latency-bound otherwise
#pragma unroll 8
  for (int k = 0; k < k_pad; ++k) {
    const long long s = slot0 + (long long)k * kLane;
    // window row of slot row k: row 0 of its 8-row group in rsrc
    const int q = __ldg(rsrc_blk + (k / kLane) * 8 * kLane + k % kLane);
    const long long col =
        ((long long)blk * bs + q - pad_sub) * kLane + (int)rsidx[s];
    racc[(int)rgid[s] * kLane + l] += to_f32(rvals[s]) * x_at(x, col, n_x, x_bf16);
  }
  float* yb = y + (long long)blk * bs * kLane + l;
  for (int g = 0; g < bs; ++g) yb[(long long)g * kLane] += racc[g * kLane + l];
}

}  // namespace

extern "C" {

// y[i] = sum_d data[d, i] * x[i + offsets[d]] for i < rows; data is
// (n_diag, rows) in f32 (data_bf16 == 0) or bf16 (data_bf16 == 1).
// Returns cudaGetLastError() after the launch.
int dia_spmv_launch(int data_bf16, const void* data, const int* offsets,
                    int n_diag, long long rows, const float* x, long long n_x,
                    float* y, void* stream) {
  const unsigned grid = (unsigned)((rows + kRowThreads - 1) / kRowThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (data_bf16) {
    dia_rows_kernel<__nv_bfloat16><<<grid, kRowThreads, 0, st>>>(
        (const __nv_bfloat16*)data, offsets, n_diag, rows, x, n_x, y);
  } else {
    dia_rows_kernel<float><<<grid, kRowThreads, 0, st>>>(
        (const float*)data, offsets, n_diag, rows, x, n_x, y);
  }
  return (int)cudaGetLastError();
}

// y[(i*bs + rgid)*128 + l] += sum_k rvals * x[(i*bs + q - pad_sub)*128 + rsidx]
// over the fringe slots (i, k, l) of nblocks blocks, k < k_pad.
int dia_resid_launch(int vals_bf16, int x_bf16, const void* rvals,
                     const int8_t* rsidx, const int8_t* rgid, const int* rsrc,
                     int nblocks, int bs, int k_pad, int n_kt, int pad_sub,
                     const float* x, long long n_x, float* y, void* stream) {
  const size_t smem = (size_t)bs * kLane * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16) {
    dia_resid_kernel<__nv_bfloat16><<<nblocks, kLane, smem, st>>>(
        (const __nv_bfloat16*)rvals, rsidx, rgid, rsrc, bs, k_pad, n_kt,
        pad_sub, x, n_x, x_bf16 != 0, y);
  } else {
    dia_resid_kernel<float><<<nblocks, kLane, smem, st>>>(
        (const float*)rvals, rsidx, rgid, rsrc, bs, k_pad, n_kt, pad_sub, x,
        n_x, x_bf16 != 0, y);
  }
  return (int)cudaGetLastError();
}

const char* dia_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
