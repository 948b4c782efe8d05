// Windowed local-gather SpMV kernels for Hopper (sm_90a), bound through a
// plain C interface.
//
// Replaces the TPU kernels of spmv_openmp_cuda_tpu/formats/window.py:
//   window_blocks_kernel <- window_kernel_call (pallas_call at :1062; its
//                           body is _gather_reduce_block, :835-951), the
//                           standard and shared_w x staging;
//   window_single_kernel <- _window_single_call (pallas_call at :1125), the
//                           single-block layout that addresses x directly
//                           (xdirect);
//   (+ window_combine_kernel, the fixed-order close of split blocks).
// Both compute, for every slot (block i, slot row k < k_pad, lane l):
//   Q   = rsrc[(i*n_kt + k/128)*128 + sidx[i,k,l], k%128]   (window row)
//   col = (x_base(i) + Q)*128 + sidx[i,k,l]                  (x read as 0
//                                                             outside [0, n))
//   r   = k < k_c ? 8*gid[i,k,l] + k%8 : gid[i,k,l]          (mod-8 fold)
//   y[(i*g + r)*128 + l] += vals[i,k,l] * x[col]             for r < g
// with x_base(i) = 8*floor(i*g/8) - wr (standard), (i - i%bps)*g - wr
// (shared_w) or 0 (xdirect): the chunk of x that window row 0 holds in the
// TPU kernel's staging. x is never rounded: only vals may be bf16.
//
// What bounds it: 2 flops per slot against vals (4 or 2 B) + sidx + gid
// (1 + 1 B) per slot, the Q map (1 B per slot row and residue), x and y:
// bytes, never arithmetic. The TPU kernel's block is a VMEM-sizing unit, not
// a unit of parallelism here (the FEM_3D_thermal2 proxy has 29 blocks, the
// delaunay proxy one), so:
//   - each CTA takes one block and a chunk of `rows` slot rows (16, 32 or
//     64: about g, so that short chunks spread the work over many CTAs
//     while the partial tiles stay under one value per slot; smaller when the
//     matrix has few blocks, so that at least ~2 CTAs per SM run), and one
//     thread per lane l;
//   - every slot (i, k, l) adds into lane l of block i, so thread l owns
//     column l of the CTA's g_pad x 128 f32 tile in shared memory and sums
//     into it without atomics or barriers. A CTA that holds all slot rows
//     of its block writes the block's rows of y itself; where several CTAs
//     share a block, each writes its tile's g rows to a scratch slot of its
//     own and window_combine_kernel adds a block's chunks in chunk order.
//     No atomics: a rerun gives the same y bit for bit, as on the TPU (the
//     price is the partial tiles' round trip through L2);
//   - the Q map is read at (sidx, k), which scatters a warp over a 16 KB
//     int8 tile: each CTA first stages its (128 x rows) slice of the tile
//     transposed in shared memory with 16-byte coalesced loads, then reads
//     it per slot from there;
//   - vals/sidx/gid of one slot row are read by 128 consecutive threads
//     (coalesced); x is gathered through the read-only cache (__ldg).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kQPitch = kLane + 4;  // bytes per staged Q row (+4: spreads banks)
constexpr int kMaxRows = 64;        // slot rows per CTA
constexpr int kMinRows = 16;        // one 16-byte vector per Q row
constexpr int kBatch = 8;           // slot rows whose loads are issued together
constexpr long long kTargetCtas = 2 * 132;  // two CTAs per SM of an H100

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One CTA: block blk, slot rows [chunk*rows, min((chunk+1)*rows, k_pad)).
template <typename T>
__device__ __forceinline__ void window_body(
    const T* __restrict__ vals, const int8_t* __restrict__ sidx,
    const int8_t* __restrict__ gid, const int8_t* __restrict__ rsrc,
    int blk, int chunk, long long x_base, int g, int k_pad, int k_c,
    int n_kt, int rows, const float* __restrict__ x, long long n_x,
    long long m, float* __restrict__ y, float* __restrict__ part, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g_pad = ((g + 7) / 8) * 8;
  float* tile = reinterpret_cast<float*>(smem);  // (g_pad, 128)
  int8_t* qs = reinterpret_cast<int8_t*>(smem + g_pad * kLane * sizeof(float));
  const int l = threadIdx.x;
  const int k0 = chunk * rows;
  const int k1 = min(k0 + rows, k_pad);
  const int kk0 = k0 % kLane;  // rows divides 128: the chunk lies in one tile

  // stage Q[res, kk0 : kk0 + rows] of tile k0/128 as qs[kk][res]
  const int8_t* qt = rsrc + ((long long)blk * n_kt + k0 / kLane) * kLane * kLane;
  const int vecs = rows / 16;
  for (int c = l; c < kLane * vecs; c += kLane) {
    const int res = c / vecs, v = c % vecs;
    const uint4 w = *reinterpret_cast<const uint4*>(qt + res * kLane + kk0 + v * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int j = 0; j < 16; ++j) qs[(v * 16 + j) * kQPitch + res] = b[j];
  }
  for (int r = 0; r < g_pad; ++r) tile[r * kLane + l] = 0.f;
  __syncthreads();

  // slot rows in batches (k_pad and rows are multiples of kBatch): every
  // load and x gather of a batch is issued before its tile updates, which
  // the compiler cannot tell apart from the staged Q (both live in smem)
  // and would otherwise wait on, one gather at a time
  const long long slot0 = (long long)blk * k_pad * kLane + l;
  for (int kb = k0; kb < k1; kb += kBatch) {
    float p[kBatch];
    int r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kb + u;
      const long long s = slot0 + (long long)k * kLane;
      const int res = sidx[s];
      const int q = qs[(k - k0) * kQPitch + res];
      const long long col = (x_base + q) * kLane + res;
      const float xv = (col >= 0 && col < n_x) ? __ldg(x + col) : 0.f;
      const int gd = gid[s];
      r[u] = k < k_c ? 8 * gd + (k & 7) : gd;
      p[u] = to_f32(vals[s]) * xv;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (r[u] < g_pad) tile[r[u] * kLane + l] += p[u];
  }

  if (n_chunks == 1) {
    const long long row0 = (long long)blk * g * kLane + l;
    for (int r = 0; r < g; ++r) {
      const long long row = row0 + (long long)r * kLane;
      if (row < m) y[row] = tile[r * kLane + l];
    }
  } else {
    float* out = part + ((long long)blk * n_chunks + chunk) * g * kLane + l;
    for (int r = 0; r < g; ++r) out[r * kLane] = tile[r * kLane + l];
  }
}

// y[(blk*g + r)*128 + l] = the chunks' partial tiles of block blk at (r, l),
// added in chunk order, for every row < m.
__global__ void __launch_bounds__(256)
window_combine_kernel(const float* __restrict__ part, int nblocks, int g, int n_chunks,
                      long long m, float* __restrict__ y) {
  const long long row = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long per_blk = (long long)g * kLane;
  if (row >= m || row >= (long long)nblocks * per_blk) return;
  const float* p = part + (row / per_blk) * n_chunks * per_blk + row % per_blk;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += p[c * per_blk];
  y[row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kLane)
window_blocks_kernel(const T* __restrict__ vals, const int8_t* __restrict__ sidx,
                     const int8_t* __restrict__ gid, const int8_t* __restrict__ rsrc,
                     int g, int k_pad, int k_c, int n_kt, int rows, int n_chunks,
                     int wr, int bps, int shared_w, const float* __restrict__ x,
                     long long n_x, long long m, float* __restrict__ y,
                     float* __restrict__ part) {
  const int blk = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
  const long long x_base = shared_w ? (long long)(blk - blk % bps) * g - wr
                                    : 8LL * (((long long)blk * g) / 8) - wr;
  window_body<T>(vals, sidx, gid, rsrc, blk, chunk, x_base, g, k_pad, k_c,
                 n_kt, rows, x, n_x, m, y, part, n_chunks);
}

template <typename T>
__global__ void __launch_bounds__(kLane)
window_single_kernel(const T* __restrict__ vals, const int8_t* __restrict__ sidx,
                     const int8_t* __restrict__ gid, const int8_t* __restrict__ rsrc,
                     int g, int k_pad, int k_c, int n_kt, int rows,
                     const float* __restrict__ x, long long n_x, long long m,
                     float* __restrict__ y, float* __restrict__ part) {
  window_body<T>(vals, sidx, gid, rsrc, 0, blockIdx.x, 0, g, k_pad, k_c, n_kt,
                 rows, x, n_x, m, y, part, gridDim.x);
}

// Slot rows per CTA: the least power of two >= g in [16, 64], so that a
// CTA's partial tile (g rows) is at most one value per slot it sums; then
// halved (down to 16) while the grid would give fewer than two CTAs per SM.
int rows_per_cta(int nblocks, int k_pad, int g) {
  int rows = kMinRows;
  while (rows < g && rows < kMaxRows) rows *= 2;
  while (rows > kMinRows &&
         (long long)nblocks * ((k_pad + rows - 1) / rows) < kTargetCtas)
    rows /= 2;
  return rows;
}

size_t smem_bytes(int g, int rows) {
  return (size_t)((g + 7) / 8) * 8 * kLane * sizeof(float) + (size_t)rows * kQPitch;
}

int chunks_of(int nblocks, int k_pad, int g) {
  const int rows = rows_per_cta(nblocks, k_pad, g);
  return (k_pad + rows - 1) / rows;
}

// After the window kernel: the combine, where blocks are split into chunks.
int combine(const float* part, int nblocks, int g, int n_chunks, long long m, float* y,
            cudaStream_t st) {
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_chunks == 1) return (int)rc;
  window_combine_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(part, nblocks, g,
                                                                       n_chunks, m, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of the scratch a launch over nblocks blocks needs (0: none).
long long window_scratch_elems(int nblocks, int k_pad, int g) {
  const int n_chunks = chunks_of(nblocks, k_pad, g);
  return n_chunks == 1 ? 0 : (long long)nblocks * n_chunks * g * kLane;
}

// y (f32, length m) = the window sums of nblocks blocks with the standard
// (shared_w == 0) or shared_w x staging; vals is f32 (vals_bf16 == 0) or
// bf16; k_pad is a multiple of 8; part holds window_scratch_elems f32.
// Writes every row of y; returns the first launch error, or 0.
int window_blocks_launch(int vals_bf16, const void* vals, const int8_t* sidx,
                         const int8_t* gid, const int8_t* rsrc, int nblocks, int g,
                         int k_pad, int k_c, int wr, int bps, int shared_w,
                         const float* x, long long n_x, long long m, float* y,
                         float* part, void* stream) {
  const int n_kt = (k_pad + kLane - 1) / kLane;
  const int rows = rows_per_cta(nblocks, k_pad, g);
  const int n_chunks = (k_pad + rows - 1) / rows;
  const unsigned grid = (unsigned)((long long)nblocks * n_chunks);
  const size_t smem = smem_bytes(g, rows);
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16) {
    window_blocks_kernel<__nv_bfloat16><<<grid, kLane, smem, st>>>(
        (const __nv_bfloat16*)vals, sidx, gid, rsrc, g, k_pad, k_c, n_kt, rows,
        n_chunks, wr, bps, shared_w, x, n_x, m, y, part);
  } else {
    window_blocks_kernel<float><<<grid, kLane, smem, st>>>(
        (const float*)vals, sidx, gid, rsrc, g, k_pad, k_c, n_kt, rows, n_chunks,
        wr, bps, shared_w, x, n_x, m, y, part);
  }
  return combine(part, nblocks, g, n_chunks, m, y, st);
}

// The same sums for the single-block xdirect layout (window row Q is x
// chunk Q).
int window_single_launch(int vals_bf16, const void* vals, const int8_t* sidx,
                         const int8_t* gid, const int8_t* rsrc, int g, int k_pad,
                         int k_c, const float* x, long long n_x, long long m,
                         float* y, float* part, void* stream) {
  const int n_kt = (k_pad + kLane - 1) / kLane;
  const int rows = rows_per_cta(1, k_pad, g);
  const int n_chunks = (k_pad + rows - 1) / rows;
  const size_t smem = smem_bytes(g, rows);
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16) {
    window_single_kernel<__nv_bfloat16><<<(unsigned)n_chunks, kLane, smem, st>>>(
        (const __nv_bfloat16*)vals, sidx, gid, rsrc, g, k_pad, k_c, n_kt, rows,
        x, n_x, m, y, part);
  } else {
    window_single_kernel<float><<<(unsigned)n_chunks, kLane, smem, st>>>(
        (const float*)vals, sidx, gid, rsrc, g, k_pad, k_c, n_kt, rows, x, n_x,
        m, y, part);
  }
  return combine(part, 1, g, n_chunks, m, y, st);
}

const char* window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
