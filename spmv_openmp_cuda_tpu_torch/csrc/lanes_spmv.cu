// Lane-gather SpMV kernel for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel spmv_openmp_cuda_tpu/formats/lanes.py::
// lanes_small_spmv (pallas_call at :170). There each (128, 128) slot tile of
// window w gathers windowT[w][a, pidx] (x viewed as 128 residues x 128
// panels, so the gather stays inside one 128-lane row, the only gather the
// TPU does fast), multiplies by vals and adds the products into y2d
// (G, 128) by G masked sublane sums, G = ceil(m/128) <= 64.
//
// On the GPU no such view is needed: slot (s, l) of a tile of window w
// stands for column c = w*16384 + pidx[s, l]*128 + (s % 128) and row
// gid[s, l]*128 + l, so the kernel reads x[c] directly (0 for c outside
// [0, n): the empty slots of the last window point there, and the TPU reads
// the zero padding of x at those columns).
//
// What bounds it: 12 B of slot arrays (value, panel, group) per slot for 2
// flops, plus x and y: slot bytes (1-5 MB on the small matrices it serves,
// 0.3-1.6 us at 3.35 TB/s), so at these sizes the launch and the host's
// per-call cost dominate, not the device. The design:
//   - lanes_kernel: one CTA of 128 threads per band of kRows slot rows,
//     thread l owns lane l. It keeps the CTA's partial y2d (G, 128) in
//     shared memory (<= 32 KB) and, since every slot of lane l adds into a
//     row of lane l, thread l alone touches column l: the G masked passes
//     become one indexed add per slot, with no conflicts and no atomics.
//     The loads of a slot row are coalesced (128 consecutive entries).
//   - lanes_combine_kernel: y[r] = sum over bands of the CTAs' partials, in
//     band order. No atomics anywhere, so a rerun gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr long long kWindow = 128LL * 128LL;  // x values per window
constexpr int kRows = 32;                     // slot rows per CTA
constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kLane)
lanes_kernel(const float* __restrict__ vals, const int* __restrict__ pidx,
             const int* __restrict__ gid, const int* __restrict__ tile_win,
             long long n_rows, int n_groups, const float* __restrict__ x,
             long long n_x, float* __restrict__ partials) {
  extern __shared__ float acc[];  // (n_groups, kLane); column l is thread l's
  const int l = threadIdx.x;
  for (int g = 0; g < n_groups; ++g) acc[g * kLane + l] = 0.f;
  const long long s0 = (long long)blockIdx.x * kRows;
  const long long s1 = s0 + kRows < n_rows ? s0 + kRows : n_rows;
#pragma unroll 8
  for (long long s = s0; s < s1; ++s) {
    const long long i = s * kLane + l;
    const long long c = (long long)__ldg(tile_win + s / kLane) * kWindow +
                        (long long)__ldg(pidx + i) * kLane + (s % kLane);
    const float xv = (c >= 0 && c < n_x) ? __ldg(x + c) : 0.f;
    const int g = __ldg(gid + i);
    if ((unsigned)g < (unsigned)n_groups) acc[g * kLane + l] += __ldg(vals + i) * xv;
  }
  float* out = partials + (long long)blockIdx.x * n_groups * kLane + l;
  for (int g = 0; g < n_groups; ++g) out[(long long)g * kLane] = acc[g * kLane + l];
}

__global__ void __launch_bounds__(kCombineThreads)
lanes_combine_kernel(const float* __restrict__ partials, int n_parts,
                     long long part_len, long long m, float* __restrict__ y) {
  const long long r = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (r >= m) return;
  float sum = 0.f;
  for (int p = 0; p < n_parts; ++p) sum += __ldg(partials + p * part_len + r);
  y[r] = sum;
}

}  // namespace

extern "C" {

// Slot rows per CTA: the wrapper sizes the partials buffer with it.
int lanes_rows_per_cta(void) { return kRows; }

// y[r] = sum over slots (s, l) with gid*128 + l == r of
// vals[s, l] * x[tile_win[s/128]*16384 + pidx[s, l]*128 + s%128], r < m,
// over n_rows slot rows. partials holds ceil(n_rows/kRows) * n_groups * 128
// floats of scratch. Returns cudaGetLastError() after the two launches.
int lanes_launch(const float* vals, const int* pidx, const int* gid,
                 const int* tile_win, long long n_rows, int n_groups,
                 const float* x, long long n_x, long long m, float* partials,
                 float* y, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_parts = (int)((n_rows + kRows - 1) / kRows);
  const size_t smem = (size_t)n_groups * kLane * sizeof(float);
  lanes_kernel<<<n_parts, kLane, smem, st>>>(vals, pidx, gid, tile_win, n_rows,
                                             n_groups, x, n_x, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((m + kCombineThreads - 1) / kCombineThreads);
  lanes_combine_kernel<<<grid, kCombineThreads, 0, st>>>(
      partials, n_parts, (long long)n_groups * kLane, m, y);
  return (int)cudaGetLastError();
}

const char* lanes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
