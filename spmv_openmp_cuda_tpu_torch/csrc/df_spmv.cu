// Double-float (f64 semantics on f32 pairs) SpMV kernels for Hopper
// (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernels that run the JAX package's float64 modes:
//   dia_df_kernel          <- ops/spmv_pallas.py::dia_spmv_pallas_df
//                             (pallas_call at :628), its diagonal sum (:530-545)
//   dia_resid_df_kernel    <- the same kernel's residual fringe (:546-595)
//   window_df_kernel       <- formats/window.py::window_kernel_call (:1062)
//   (+ window_df_combine_kernel)  and _window_single_call (:1125) in their df
//                             mode (vals_lo, xp2_lo / x2d_lo): the body is
//                             _gather_reduce_block's df branches (:868-951)
//   routed_df_gather_kernel <- formats/routed.py::_gather_products_df (:1882)
// (all paths under spmv_openmp_cuda_tpu/).
//
// Every f64 operand is an (hi, lo) pair of f32s, hi = f32(a), lo = f32(a -
// hi). A product is Dekker's TwoProduct of the hi words plus the cross terms
// hi*lo + lo*hi in f32; a sum is Knuth's TwoSum of the hi words with the low
// words added (spmv_openmp_cuda_tpu_torch/ops/dfloat.py).
//
// The FMA rule. By default nvcc contracts a multiply followed by an add into
// one FMA. Inside TwoSum or TwoProduct that keeps the unrounded product while
// the error term is taken for the rounded one, and the pair collapses to f32
// accuracy. So every df operation below is written with the rounding
// intrinsics __fmul_rn, __fadd_rn and __fsub_rn, which the compiler never
// contracts, and TwoProduct takes its error exactly as __fmaf_rn(a, b, -p)
// (equal to the Veltkamp error of the plain versions when nothing
// overflows). The source is built without --use_fast_math.
//
// What bounds them: bytes. Each stored slot costs ~30 f32 operations (a
// TwoProduct, two cross terms, a TwoSum) against 8 B of (hi, lo) values plus
// its index bytes; at 67 TFLOP/s of f32 that is ~4 ops per byte of a card
// that moves 3.35 TB/s, below the ~20 the card can do per byte. The designs
// are the f32 kernels' (csrc/dia_spmv.cu, window_spmv.cu, routed_spmv.cu)
// with pairs, except where a sum crosses threads:
//   - dia_df_kernel: one thread per output row, both slab planes read
//     coalesced, x read behind a bounds test to the end of x (the TPU
//     window's clip of x at (S + pad_sub)*128 is not copied). Each row has
//     one owner: no atomics. dia_resid_df_kernel adds the fringe afterwards,
//     one CTA per TPU block and one thread per lane, each thread owning its
//     lane's rows in a shared-memory pair tile (as dia_resid_kernel).
//   - window_df_kernel: the f32 window kernel closes with one global
//     atomicAdd per partial sum, because several CTAs share a block. An
//     atomicAdd on the hi word would throw its rounding error away. So here
//     a CTA either owns all slot rows of its block and writes the block's
//     rows itself (when the blocks alone give >= 2 CTAs per SM, e.g.
//     thermal2_like), or the block's slot rows are split into chunks, each
//     CTA writes its partial (hi, lo) tile to scratch, and
//     window_df_combine_kernel adds the chunks of each row with TwoSum in
//     chunk order. Either way the result does not depend on scheduling.
//     The Q map is staged in shared memory per 16 to 64 slot rows.
//   - routed_df_gather_kernel: one thread per slot of the gather tiles
//     (coalesced value and index reads, x gathered by global column), pad
//     tiles written as zeros. It takes no W1: the products permutation runs
//     on each plane through routed_w_stage_kernel (exact data movement).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kQPitch = kLane + 4;       // bytes per staged Q row (+4: spreads banks)
constexpr int kMinRows = 16;             // one 16-byte vector per staged Q row
constexpr int kSubRows = 64;             // slot rows per Q staging
constexpr int kBatch = 8;                // slot rows whose loads are issued together
constexpr long long kTargetCtas = 2 * 132;  // two CTAs per SM of an H100
constexpr long long kWindowElems = 128LL * 128;

// ---- double-float primitives (never contracted) --------------------------

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (p, e): p = fl(a*b), e = a*b - p exactly
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

// the product of two pairs as a pair (hi word exact, cross terms in f32)
__device__ __forceinline__ void df_prod(float vh, float vl, float xh, float xl, float& ph,
                                        float& pl) {
  float e;
  two_prod(vh, xh, ph, e);
  pl = __fadd_rn(e, __fadd_rn(__fmul_rn(vh, xl), __fmul_rn(vl, xh)));
}

// (ah, al) += (bh, bl)
__device__ __forceinline__ void df_add(float& ah, float& al, float bh, float bl) {
  float s, e;
  two_sum(ah, bh, s, e);
  ah = s;
  al = __fadd_rn(__fadd_rn(al, bl), e);
}

// (ah, al) += (vh, vl) * (xh, xl): df_mul_acc of the plain versions
__device__ __forceinline__ void df_mul_acc(float& ah, float& al, float vh, float vl, float xh,
                                           float xl) {
  float p, e;
  two_prod(vh, xh, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(vh, xl), __fmul_rn(vl, xh)));
  float s, err;
  two_sum(ah, p, s, err);
  ah = s;
  al = __fadd_rn(al, __fadd_rn(err, e));
}

// x pair at col, zero outside [0, n_x)
__device__ __forceinline__ void x_pair(const float* __restrict__ xh, const float* __restrict__ xl,
                                       long long col, long long n_x, float& h, float& l) {
  if (col >= 0 && col < n_x) {
    h = __ldg(xh + col);
    l = __ldg(xl + col);
  } else {
    h = 0.f;
    l = 0.f;
  }
}

// ---- DIA ------------------------------------------------------------------

// (yh, yl)[i] = sum_d (dh, dl)[d, i] * x[i + offsets[d]] for i < rows,
// summed in ascending offset order
__global__ void __launch_bounds__(kThreads)
dia_df_kernel(const float* __restrict__ dh, const float* __restrict__ dl,
              const int* __restrict__ offsets, int n_diag, long long rows,
              const float* __restrict__ xh, const float* __restrict__ xl, long long n_x,
              float* __restrict__ yh, float* __restrict__ yl) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows) return;
  float ah = 0.f, al = 0.f;
#pragma unroll 4
  for (int d = 0; d < n_diag; ++d) {
    float vh_x, vl_x;
    x_pair(xh, xl, i + __ldg(offsets + d), n_x, vh_x, vl_x);
    const long long e = (long long)d * rows + i;
    df_mul_acc(ah, al, dh[e], dl[e], vh_x, vl_x);
  }
  yh[i] = ah;
  yl[i] = al;
}

// fringe slot (blk, k, l) adds (rvh, rvl) * x[(blk*bs + q - pad_sub)*128 +
// rsidx] into row (blk*bs + rgid)*128 + l; thread l of CTA blk owns those
// rows: it sums them in shared memory, then adds them to (yh, yl)
__global__ void __launch_bounds__(kLane)
dia_resid_df_kernel(const float* __restrict__ rvh, const float* __restrict__ rvl,
                    const int8_t* __restrict__ rsidx, const int8_t* __restrict__ rgid,
                    const int* __restrict__ rsrc, int bs, int k_pad, int n_kt, int pad_sub,
                    const float* __restrict__ xh, const float* __restrict__ xl, long long n_x,
                    float* __restrict__ yh, float* __restrict__ yl) {
  extern __shared__ float racc[];  // (2, bs, kLane): hi words, then lo words
  float* rh = racc;
  float* rl = racc + bs * kLane;
  const int blk = blockIdx.x;
  const int l = threadIdx.x;
  for (int g = 0; g < bs; ++g) {
    rh[g * kLane + l] = 0.f;
    rl[g * kLane + l] = 0.f;
  }
  const long long slot0 = (long long)blk * k_pad * kLane + l;
  const int* rsrc_blk = rsrc + (long long)blk * n_kt * 8 * kLane;
#pragma unroll 4
  for (int k = 0; k < k_pad; ++k) {
    const long long s = slot0 + (long long)k * kLane;
    const int q = __ldg(rsrc_blk + (k / kLane) * 8 * kLane + k % kLane);
    const long long col = ((long long)blk * bs + q - pad_sub) * kLane + (int)rsidx[s];
    float gh, gl, ph, pl;
    x_pair(xh, xl, col, n_x, gh, gl);
    df_prod(rvh[s], rvl[s], gh, gl, ph, pl);
    const int g = (int)rgid[s] * kLane + l;
    df_add(rh[g], rl[g], ph, pl);
  }
  const long long row0 = (long long)blk * bs * kLane + l;
  for (int g = 0; g < bs; ++g) {
    const long long row = row0 + (long long)g * kLane;
    float h = yh[row], lo = yl[row];
    df_add(h, lo, rh[g * kLane + l], rl[g * kLane + l]);
    yh[row] = h;
    yl[row] = lo;
  }
}

// ---- window ---------------------------------------------------------------

// Slot rows per CTA: the least power of two >= k_pad (one CTA per block),
// halved (down to 16) while the grid would give fewer than two CTAs per SM.
int df_rows_per_cta(int nblocks, int k_pad) {
  int rows = kMinRows;
  while (rows < k_pad) rows *= 2;
  while (rows > kMinRows && (long long)nblocks * ((k_pad + rows - 1) / rows) < kTargetCtas)
    rows /= 2;
  return rows;
}

__host__ __device__ __forceinline__ int g_pad_of(int g) { return ((g + 7) / 8) * 8; }

size_t window_df_smem(int g, int rows) {
  const int sub = rows < kSubRows ? rows : kSubRows;
  return (size_t)2 * g_pad_of(g) * kLane * sizeof(float) + (size_t)sub * kQPitch;
}

// One CTA: block blk, slot rows [chunk*rows, min((chunk+1)*rows, k_pad)),
// one thread per lane l; slot (blk, k, l) adds (vh, vl) * x[(x_base + Q)*128
// + sidx] into row r = k < k_c ? 8*gid + k%8 : gid of the block (rows r >= g
// are padding). With n_chunks == 1 the CTA writes rows r < g of y itself;
// otherwise its (g_pad, 128) partial pair tile goes to scratch.
__global__ void __launch_bounds__(kLane)
window_df_kernel(const float* __restrict__ vh, const float* __restrict__ vl,
                 const int8_t* __restrict__ sidx, const int8_t* __restrict__ gid,
                 const int8_t* __restrict__ rsrc, int g, int k_pad, int k_c, int n_kt, int rows,
                 int n_chunks, int wr, int bps, int xmode, const float* __restrict__ xh,
                 const float* __restrict__ xl, long long n_x, long long m,
                 float* __restrict__ yh, float* __restrict__ yl, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g_pad = g_pad_of(g);
  float* th = reinterpret_cast<float*>(smem);  // (g_pad, 128) hi words
  float* tl = th + g_pad * kLane;              // (g_pad, 128) lo words
  int8_t* qs = reinterpret_cast<int8_t*>(tl + g_pad * kLane);
  const int blk = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
  const int l = threadIdx.x;
  // x chunk held by window row 0: 8*floor(blk*g/8) - wr (standard), 0
  // (xdirect), (blk - blk%bps)*g - wr (shared_w)
  const long long x_base = xmode == 1 ? 0LL
                           : xmode == 2 ? (long long)(blk - blk % bps) * g - wr
                                        : 8LL * (((long long)blk * g) / 8) - wr;
  for (int r = 0; r < g_pad; ++r) {
    th[r * kLane + l] = 0.f;
    tl[r * kLane + l] = 0.f;
  }
  const int k0 = chunk * rows;
  const int k1 = min(k0 + rows, k_pad);
  const int sub = rows < kSubRows ? rows : kSubRows;  // divides rows and 128
  const long long slot0 = (long long)blk * k_pad * kLane + l;
  for (int ks = k0; ks < k1; ks += sub) {
    // stage Q[res, ks%128 : ks%128 + sub] of tile ks/128 as qs[kk][res]
    const int8_t* qt = rsrc + ((long long)blk * n_kt + ks / kLane) * kLane * kLane;
    const int vecs = sub / 16;
    __syncthreads();  // the previous staging is no longer read
    for (int c = l; c < kLane * vecs; c += kLane) {
      const int res = c / vecs, v = c % vecs;
      const uint4 w = *reinterpret_cast<const uint4*>(qt + res * kLane + ks % kLane + v * 16);
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int j = 0; j < 16; ++j) qs[(v * 16 + j) * kQPitch + res] = b[j];
    }
    __syncthreads();
    const int ke = min(ks + sub, k1);
    for (int kb = ks; kb < ke; kb += kBatch) {
      float ph[kBatch], pl[kBatch];
      int rr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = kb + u;
        const long long s = slot0 + (long long)k * kLane;
        const int res = sidx[s];
        const int q = qs[(k - ks) * kQPitch + res];
        float gh, gl;
        x_pair(xh, xl, (x_base + q) * kLane + res, n_x, gh, gl);
        const int gd = gid[s];
        rr[u] = k < k_c ? 8 * gd + (k & 7) : gd;
        df_prod(vh[s], vl[s], gh, gl, ph[u], pl[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (rr[u] < g_pad) df_add(th[rr[u] * kLane + l], tl[rr[u] * kLane + l], ph[u], pl[u]);
    }
  }
  if (n_chunks == 1) {
    const long long row0 = (long long)blk * g * kLane + l;
    for (int r = 0; r < g; ++r) {
      const long long row = row0 + (long long)r * kLane;
      if (row < m) {
        yh[row] = th[r * kLane + l];
        yl[row] = tl[r * kLane + l];
      }
    }
  } else {
    const long long tile = (long long)g_pad * kLane;
    float* ph_out = part + (long long)blockIdx.x * tile;
    float* pl_out = part + (long long)gridDim.x * tile + (long long)blockIdx.x * tile;
    for (int r = 0; r < g_pad; ++r) {
      ph_out[r * kLane + l] = th[r * kLane + l];
      pl_out[r * kLane + l] = tl[r * kLane + l];
    }
  }
}

// (yh, yl)[(blk*g + r)*128 + l] = sum over chunks c, in order, of the
// partial tiles (blk*n_chunks + c) at (r, l); r < g, rows < m
__global__ void __launch_bounds__(kThreads)
window_df_combine_kernel(const float* __restrict__ part, int nblocks, int g, int n_chunks,
                         long long m, float* __restrict__ yh, float* __restrict__ yl) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long per_blk = (long long)g * kLane;
  if (idx >= (long long)nblocks * per_blk) return;
  const long long row = idx;  // = (blk*g + r)*128 + l
  if (row >= m) return;
  const int blk = (int)(idx / per_blk);
  const long long rl = idx % per_blk;  // r*128 + l
  const long long tile = (long long)g_pad_of(g) * kLane;
  const long long planes = (long long)nblocks * n_chunks * tile;
  const float* p = part + (long long)blk * n_chunks * tile + rl;
  float h = 0.f, lo = 0.f;
  for (int c = 0; c < n_chunks; ++c) df_add(h, lo, p[c * tile], p[planes + c * tile]);
  yh[row] = h;
  yl[row] = lo;
}

// ---- routed ---------------------------------------------------------------

// tile i < n_real, slot (s, l): (oh, ol)[i*128 + s, l] = (vh, vl)[i*128 + s, l]
// * x[widx[i]*16384 + pidx[i*128 + s, l]*128 + s]; tiles i >= n_real zero
__global__ void __launch_bounds__(kThreads)
routed_df_gather_kernel(const float* __restrict__ vh, const float* __restrict__ vl,
                        const int8_t* __restrict__ pidx, const int32_t* __restrict__ widx,
                        int n_real, long long n_elems, const float* __restrict__ xh,
                        const float* __restrict__ xl, long long n_x, float* __restrict__ oh,
                        float* __restrict__ ol) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_elems) return;
  const long long tile = e / kWindowElems;
  if (tile >= n_real) {
    oh[e] = 0.f;
    ol[e] = 0.f;
    return;
  }
  const int s = (int)((e / kLane) % kLane);
  const long long col = (long long)__ldg(widx + tile) * kWindowElems + (long long)pidx[e] * kLane + s;
  float gh, gl, ph, pl;
  x_pair(xh, xl, col, n_x, gh, gl);
  df_prod(vh[e], vl[e], gh, gl, ph, pl);
  oh[e] = ph;
  ol[e] = pl;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// (yh, yl)[i] for i < rows over the (n_diag, rows) slab pair; returns
// cudaGetLastError() after the launch.
int dia_df_launch(const float* dh, const float* dl, const int* offsets, int n_diag,
                  long long rows, const float* xh, const float* xl, long long n_x, float* yh,
                  float* yl, void* stream) {
  dia_df_kernel<<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      dh, dl, offsets, n_diag, rows, xh, xl, n_x, yh, yl);
  return (int)cudaGetLastError();
}

// (yh, yl) += the fringe sums of nblocks TPU blocks (bs <= 42, so the pair
// tile stays under 48 KB of shared memory).
int dia_resid_df_launch(const float* rvh, const float* rvl, const int8_t* rsidx,
                        const int8_t* rgid, const int* rsrc, int nblocks, int bs, int k_pad,
                        int n_kt, int pad_sub, const float* xh, const float* xl, long long n_x,
                        float* yh, float* yl, void* stream) {
  const size_t smem = (size_t)2 * bs * kLane * sizeof(float);
  dia_resid_df_kernel<<<(unsigned)nblocks, kLane, smem, (cudaStream_t)stream>>>(
      rvh, rvl, rsidx, rgid, rsrc, bs, k_pad, n_kt, pad_sub, xh, xl, n_x, yh, yl);
  return (int)cudaGetLastError();
}

// f32 elements of the scratch window_df_launch needs (0: none).
long long window_df_scratch_elems(int nblocks, int k_pad, int g) {
  const int rows = df_rows_per_cta(nblocks, k_pad);
  const int n_chunks = (k_pad + rows - 1) / rows;
  if (n_chunks == 1) return 0;
  return 2LL * nblocks * n_chunks * g_pad_of(g) * kLane;
}

// (yh, yl) (length m) = the window sums of nblocks blocks; xmode 0 standard,
// 1 xdirect, 2 shared_w x staging; scratch holds window_df_scratch_elems
// f32. Overwrites every row of y; returns the first launch error, or 0.
int window_df_launch(const float* vh, const float* vl, const int8_t* sidx, const int8_t* gid,
                     const int8_t* rsrc, int nblocks, int g, int k_pad, int k_c, int wr, int bps,
                     int xmode, const float* xh, const float* xl, long long n_x, long long m,
                     float* yh, float* yl, float* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_kt = (k_pad + kLane - 1) / kLane;
  const int rows = df_rows_per_cta(nblocks, k_pad);
  const int n_chunks = (k_pad + rows - 1) / rows;
  const size_t smem = window_df_smem(g, rows);
  // above 48 KB of dynamic shared memory for g > 40; the attribute is per
  // device, so it is set on every launch (cheap, allowed in graph capture)
  const cudaError_t e = cudaFuncSetAttribute(
      window_df_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  window_df_kernel<<<(unsigned)((long long)nblocks * n_chunks), kLane, smem, st>>>(
      vh, vl, sidx, gid, rsrc, g, k_pad, k_c, n_kt, rows, n_chunks, wr, bps, xmode, xh, xl, n_x,
      m, yh, yl, scratch);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_chunks == 1) return (int)rc;
  window_df_combine_kernel<<<blocks_for((long long)nblocks * g * kLane), kThreads, 0, st>>>(
      scratch, nblocks, g, n_chunks, m, yh, yl);
  return (int)cudaGetLastError();
}

// (oh, ol) (n_tiles*128 rows of 128): the df products of the n_real gather
// tiles, then zero tiles.
int routed_df_gather_launch(const float* vh, const float* vl, const int8_t* pidx,
                            const int32_t* widx, int n_real, int n_tiles, const float* xh,
                            const float* xl, long long n_x, float* oh, float* ol, void* stream) {
  const long long n = (long long)n_tiles * kWindowElems;
  routed_df_gather_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      vh, vl, pidx, widx, n_real, n, xh, xl, n_x, oh, ol);
  return (int)cudaGetLastError();
}

const char* df_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
