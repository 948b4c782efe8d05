// Double-float (f64 semantics on f32 pairs) SpMV kernels for Hopper
// (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernels that run the JAX package's float64 modes:
//   dia_df_kernel          <- ops/spmv_pallas.py::dia_spmv_pallas_df
//                             (pallas_call at :628) without a fringe: its
//                             diagonal sum (:530-545)
//   dia_resid_df_kernel    <- the same kernel with the residual fringe: the
//                             whole DIA+residual product (the diagonal sum,
//                             then the fringe sums :546-595) in one launch
//   window_df_kernel       <- formats/window.py::window_kernel_call (:1062)
//                             and _window_single_call (:1125) in their df
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
//     one owner: no atomics.
//   - dia_resid_df_kernel: csrc/dia_spmv.cu's dia_resid_kernel with pairs,
//     one launch per product: a row's diagonals split over `groups`
//     threads whose pairs are TwoSum-added in group order in shared memory,
//     the fringe as per-row lists ((hi, lo) value, x column) walked in
//     ascending slot row k by one thread of the row. Like window_df_kernel
//     it takes x in f64 and splits each element it reads exactly as
//     ops/dfloat.py::split_f64_t does, and writes y in f64 as hi + lo
//     (df_combine64): the wrapper launches nothing else.
//   - window_df_kernel: window_spmv.cu's design with pairs (a CTA, or a
//     thread-block cluster, per block; warp j owns the tile rows r % 8 == j,
//     so every cell has one writer in a fixed order and a rerun is bitwise
//     equal; the overflow rows copied once per CTA; the cluster's tiles are
//     TwoSum-added in rank order through distributed shared memory). One
//     launch per product: it stages the f64 x window with one bulk copy,
//     splits it in place into (hi, lo) pairs exactly as
//     ops/dfloat.py::split_f64_t does, and writes y in f64 as hi + lo
//     (df_combine64), so the wrapper neither splits x nor combines y. Shared memory: the x window <= 128 KB, the pair tile <=
//     64 KB, the Q chunk 8.5 KB, a cp.async ring of 4 stages of 40 bytes
//     per thread (2 where the window and tile leave no room for 4).
//   - routed_df_gather_kernel: one thread per slot of the gather tiles
//     (coalesced value and index reads, x gathered by global column), pad
//     tiles written as zeros. It takes no W1: the products permutation runs
//     on each plane through routed_w_stage_kernel (exact data movement).
#include "window_tile.cuh"

namespace {

using wtile::kLane;
using wtile::kThreads;
constexpr long long kWindowElems = 128LL * 128;
// dia_resid_df_kernel: threads per CTA, and the most threads a row's
// diagonals are split over (csrc/dia_spmv.cu's dia_resid_kernel)
constexpr int kResidThreads = 256;
constexpr int kMaxGroups = 16;

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

// x[col] split into its (hi, lo) pair as ops/dfloat.py::split_f64_t splits
// it (hi = f32(v), lo = f32(v - hi)); (0, 0) outside [0, n_x)
__device__ __forceinline__ void x_split(const double* __restrict__ x, long long col,
                                        long long n_x, float& h, float& l) {
  if (col >= 0 && col < n_x) {
    const double v = __ldg(x + col);
    h = (float)v;
    l = (float)(v - (double)h);
  } else {
    h = 0.f;
    l = 0.f;
  }
}

// y[i] (f64) = (diagonal pair sum of row i) + (fringe pair sum of row i),
// combined as hi + lo, for i < m: dia_resid_kernel's design (csrc/
// dia_spmv.cu) with (hi, lo) pairs. Thread t takes row r = t % R of the
// CTA's R = kResidThreads / groups rows and the diagonals [g*D/groups,
// (g+1)*D/groups) of group g = t / R, summed by df_mul_acc in ascending
// offset order; the last group TwoSum-adds the row's fringe list in list
// order (ascending slot row k); group 0 TwoSum-adds the groups' pairs in
// group order, then the fringe pair.
__global__ void __launch_bounds__(kResidThreads)
dia_resid_df_kernel(const float* __restrict__ dh, const float* __restrict__ dl,
                    const int* __restrict__ offsets, int n_diag, long long rows, long long m,
                    const int* __restrict__ row_ptr, const float* __restrict__ fh,
                    const float* __restrict__ fl, const int* __restrict__ fcol,
                    const double* __restrict__ x, long long n_x, int groups,
                    double* __restrict__ y) {
  __shared__ float2 part[kResidThreads];  // part[g * R + r]: group g's pair of row r
  __shared__ float2 fring[kResidThreads];
  const int R = kResidThreads / groups;
  const int r = threadIdx.x % R, g = threadIdx.x / R;
  const long long i = (long long)blockIdx.x * R + r;
  const bool live = i < m;
  float ah = 0.f, al = 0.f;
  if (live) {
    const int d1 = (g + 1) * n_diag / groups;
#pragma unroll 4
    for (int d = g * n_diag / groups; d < d1; ++d) {
      float xh, xl;
      x_split(x, i + __ldg(offsets + d), n_x, xh, xl);
      const long long e = (long long)d * rows + i;
      df_mul_acc(ah, al, dh[e], dl[e], xh, xl);
    }
  }
  part[threadIdx.x] = make_float2(ah, al);
  if (g == groups - 1 && live) {
    float rh = 0.f, rl = 0.f;
    const int e1 = __ldg(row_ptr + i + 1);
    for (int e = __ldg(row_ptr + i); e < e1; ++e) {
      float gh, gl, ph, pl;
      x_split(x, __ldg(fcol + e), n_x, gh, gl);
      df_prod(__ldg(fh + e), __ldg(fl + e), gh, gl, ph, pl);
      df_add(rh, rl, ph, pl);
    }
    fring[r] = make_float2(rh, rl);
  }
  __syncthreads();
  if (g == 0 && live) {
    float2 s = part[r];
    for (int h = 1; h < groups; ++h) {
      const float2 o = part[h * R + r];
      df_add(s.x, s.y, o.x, o.y);
    }
    const float2 f = fring[r];
    df_add(s.x, s.y, f.x, f.y);
    y[i] = (double)s.x + (double)s.y;
  }
}

// ---- window ---------------------------------------------------------------

struct WinDfArgs {
  const float* vh;
  const float* vl;
  const int8_t* sidx;
  const int8_t* gid;
  const int8_t* rsrc;
  const double* x;
  double* y;
  long long n_x, m;
  int g, k_pad, k_c, n_kt, wr, bps, xmode, step, win_rows;
};

// One mod-8 slot row k (Q chunk c0) of this thread's 4 lanes, from its ring
// stage: each lane's product pair TwoSum-added into row 8*gid + w of the
// tile, which warp w owns.
__device__ __forceinline__ void df_slot_row(float4 vh4, float4 vl4, char4 sc, char4 gc, int k,
                                            int c0, int g_pad, const float2* xs, float2* tile,
                                            const int8_t* qs) {
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float hv[4] = {vh4.x, vh4.y, vh4.z, vh4.w};
  const float lv[4] = {vl4.x, vl4.y, vl4.z, vl4.w};
  const int8_t sv[4] = {sc.x, sc.y, sc.z, sc.w};
  const int8_t gv[4] = {gc.x, gc.y, gc.z, gc.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 8 * (int)gv[i] + w;
    if (r >= g_pad) continue;
    const int res = sv[i];
    // Q < win_rows: ops/window_cuda.py checks it once per layout
    const float2 xv = xs[qs[res * wtile::kQPitch + (k - c0)] * kLane + res];
    float ph, pl;
    df_prod(hv[i], lv[i], xv.x, xv.y, ph, pl);
    float2& c = tile[r * kLane + i * 32 + t];
    df_add(c.x, c.y, ph, pl);
  }
}

// One overflow slot row k, its 128 lanes from the loader's ring slots (the
// f32 kernel's overflow_lane): warp w takes lane 4t + w%4 and TwoSum-adds it
// into row gid if gid % 2 == w/4.
__device__ __forceinline__ void df_overflow_lane(const float* rh, const float* rl,
                                                 const int8_t* rs, const int8_t* rg, int k,
                                                 int c0, int g_pad, const float2* xs,
                                                 float2* tile, const int8_t* qs) {
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5, i = w & 3;
  const int e = 4 * t + i;
  const int r = rg[e];
  if ((r & 1) != (w >> 2) || r >= g_pad) return;
  const int res = rs[e];
  const float2 xv = xs[qs[res * wtile::kQPitch + (k - c0)] * kLane + res];
  float ph, pl;
  df_prod(rh[e], rl[e], xv.x, xv.y, ph, pl);
  float2& c = tile[r * kLane + i * 32 + t];
  df_add(c.x, c.y, ph, pl);
}

// One CTA: block blk, slot rows [rank*rows, min((rank+1)*rows, k_pad)); the
// design of window_spmv.cu with (hi, lo) pairs and a ring of D stages: the
// x window staged as f64 by the bulk copy and split in place into (hi, lo)
// f32 pairs (bitwise ops/dfloat.py::split_f64_t), a tile of pairs, y
// written as hi + lo in f64 (bitwise df_combine64).
template <int D>
__global__ void __launch_bounds__(wtile::kThreads, 2)
window_df_kernel(WinDfArgs a, int csize) {
  namespace cg = cooperative_groups;
  using namespace wtile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g_pad = g_pad_of(a.g);
  double* xd = reinterpret_cast<double*>(smem);
  float2* xs = reinterpret_cast<float2*>(smem);  // the same bytes, split
  float2* tile = xs + a.win_rows * kLane;
  int8_t* qs = reinterpret_cast<int8_t*>(tile + g_pad * kLane);
  float4* ringh = reinterpret_cast<float4*>(qs + kQBytes);  // [D][kThreads]
  float4* ringl = ringh + D * kThreads;
  char4* rings = reinterpret_cast<char4*>(ringl + D * kThreads);
  char4* ringg = rings + D * kThreads;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ringg + D * kThreads);
  const int blk = a.xmode == 1 ? 0 : blockIdx.x / csize;
  const int rank = blockIdx.x % csize;
  const int tid = threadIdx.x, t = tid & 31, w = tid >> 5;
  const long long x_base = x_base_of(a.xmode, blk, a.g, a.wr, a.bps);
  const int k0 = rank_start(rank, a.step, a.k_c, a.k_pad);
  const int k1 = rank == csize - 1 ? a.k_pad : rank_start(rank + 1, a.step, a.k_c, a.k_pad);
  const WarpRows rows(k0, k1, a.k_c, w);
  const long long base = (long long)blk * a.k_pad * kLane + 4 * t;

  // the ring and the Q chunks as in window_spmv.cu
  int queued = 0;
  auto enqueue = [&]() {
    if (queued < rows.total) {
      const long long off = base + (long long)rows.row(queued) * kLane;
      const int slot = (queued % D) * kThreads + tid;
      cp_async<16>(ringh + slot, a.vh + off);
      cp_async<16>(ringl + slot, a.vl + off);
      cp_async<4>(rings + slot, a.sidx + off);
      cp_async<4>(ringg + slot, a.gid + off);
    }
    cp_async_commit();
    ++queued;
  };
  for (int j = 0; j < D; ++j) enqueue();
  int q_c0 = -1, next_c0 = k0 / kQRows * kQRows;
  uint4 qv[kQVecs];
  if (next_c0 < k1) load_q(qv, a.rsrc, blk, a.n_kt, next_c0);
  auto stage_next_q = [&]() {
    __syncthreads();  // the split window, the previous chunk's Q and tile updates
    store_q(qs, qv);
    q_c0 = next_c0;
    next_c0 += kQRows;
    if (next_c0 < k1) load_q(qv, a.rsrc, blk, a.n_kt, next_c0);
    __syncthreads();
  };
  for (int e = tid; e < g_pad * kLane; e += kThreads) tile[e] = make_float2(0.f, 0.f);
  stage_x(xd, a.x, a.n_x, x_base * kLane, a.win_rows * kLane, bar);
  for (int e = tid; e < a.win_rows * kLane; e += kThreads) {
    const double v = xd[e];  // each thread rewrites the 8 bytes it read
    const float h = (float)v;
    xs[e] = make_float2(h, (float)(v - (double)h));
  }
  __syncthreads();  // the split window

  int j = 0;
  while (next_c0 < rows.m8) {
    stage_next_q();
    for (; j < rows.n8 && rows.row(j) < q_c0 + kQRows; ++j) {
      cp_async_wait<D - 1>();
      const int slot = (j % D) * kThreads + tid;
      df_slot_row(ringh[slot], ringl[slot], rings[slot], ringg[slot], rows.row(j), q_c0, g_pad,
                  xs, tile, qs);
      enqueue();
    }
  }
  for (int s0 = rows.ov0; s0 < k1; s0 += 8 * D) {
    const int s1 = min(s0 + 8 * D, k1);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = s0; k < s1; ++k) {
      if (q_c0 < 0 || k >= q_c0 + kQRows) stage_next_q();
      const int b = rows.overflow_base<D>(k);
      df_overflow_lane(reinterpret_cast<const float*>(ringh + b),
                       reinterpret_cast<const float*>(ringl + b),
                       reinterpret_cast<const int8_t*>(rings + b),
                       reinterpret_cast<const int8_t*>(ringg + b), k, q_c0, g_pad, xs, tile, qs);
    }
    __syncthreads();
    for (int i = 0; i < D; ++i) enqueue();
  }
  cp_async_wait<0>();
  __syncthreads();

  const long long row0 = (long long)blk * a.g * kLane;
  cg::cluster_group cluster = cg::this_cluster();
  if (csize > 1) cluster.sync();
  for (int r = rank + csize * w; r < a.g; r += csize * kWarps) {
    float2 v[4];
    const float2* t0 = csize > 1 ? cluster.map_shared_rank(tile, 0) : tile;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = t0[r * kLane + i * 32 + t];
    for (int s = 1; s < csize; ++s) {
      const float2* ts = cluster.map_shared_rank(tile, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 o = ts[r * kLane + i * 32 + t];
        df_add(v[i].x, v[i].y, o.x, o.y);
      }
    }
    const long long row = row0 + (long long)r * kLane + 4 * t;
    double out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (double)v[i].x + (double)v[i].y;
    if (row + 3 < a.m) {
      reinterpret_cast<double2*>(a.y + row)[0] = make_double2(out[0], out[1]);
      reinterpret_cast<double2*>(a.y + row)[1] = make_double2(out[2], out[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (row + i < a.m) a.y[row + i] = out[i];
    }
  }
  if (csize > 1) cluster.sync();  // no CTA leaves while its tile is read
}

template <int D>
cudaError_t window_df_launch_d(const WinDfArgs& a, int nblocks, int csize, int smem,
                               cudaStream_t st) {
  // above 48 KB of dynamic shared memory; the attribute is per device, so
  // it is set on every launch (cheap, allowed in graph capture)
  cudaError_t e = cudaFuncSetAttribute(window_df_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)nblocks * csize));
  cfg.blockDim = dim3(wtile::kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, window_df_kernel<D>, a, csize);
  return e != cudaSuccess ? e : cudaGetLastError();
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

// y (f64, length m) = the DIA+residual product over the (n_diag, rows) slab
// pair and the per-row fringe lists (fh, fl, fcol; row i's entries
// row_ptr[i] .. row_ptr[i + 1] - 1), x in f64, split in the kernel. groups
// is 1, 2, 4, 8 or 16 (ops/spmv_cuda.py::launch_groups). Returns
// cudaErrorInvalidValue for another groups, else cudaGetLastError() after
// the launch.
int dia_resid_df_launch(const float* dh, const float* dl, const int* offsets, int n_diag,
                        long long rows, long long m, const int* row_ptr, const float* fh,
                        const float* fl, const int* fcol, const double* x, long long n_x,
                        double* y, int groups, void* stream) {
  if (groups < 1 || groups > kMaxGroups || (groups & (groups - 1)) || m < 1)
    return (int)cudaErrorInvalidValue;
  const long long per_cta = kResidThreads / groups;
  dia_resid_df_kernel<<<(unsigned)((m + per_cta - 1) / per_cta), kResidThreads, 0,
                        (cudaStream_t)stream>>>(dh, dl, offsets, n_diag, rows, m, row_ptr, fh, fl,
                                                fcol, x, n_x, groups, y);
  return (int)cudaGetLastError();
}

// y (f64, length m) = the window sums of nblocks blocks of a double-float
// layout (vh, vl: the (hi, lo) value planes), x in f64; xmode 0 standard,
// 1 xdirect, 2 shared_w. One launch: the launch plan of window_spmv.cu's
// window_launch (ops/window_cuda.py::launch_plan: a ring of depth 4, 2 or
// 1; smem with 8-byte x and tile elements). Writes every
// row of y; returns cudaErrorInvalidValue for a plan it does not take, else
// the launch's error, or 0.
int window_df_launch(const float* vh, const float* vl, const int8_t* sidx, const int8_t* gid,
                     const int8_t* rsrc, int nblocks, int g, int k_pad, int k_c, int wr, int bps,
                     int xmode, const double* x, long long n_x, long long m, double* y,
                     int csize, int step, int win_rows, int depth, int smem, void* stream) {
  using namespace wtile;
  const bool csize_ok = csize == 1 || csize == 2 || csize == 4 || csize == kMaxCluster;
  const long long cost = k_c + (long long)kOverflowCost * (k_pad - k_c);
  if (!csize_ok || step <= 0 || (long long)csize * step < cost || win_rows < 1 ||
      win_rows > kLane || (depth != 1 && depth != 2 && depth != 4) ||
      (size_t)smem != window_smem_bytes(g, win_rows, 8, 8, 32, depth) ||
      (xmode == 1 && nblocks != 1))
    return (int)cudaErrorInvalidValue;
  WinDfArgs a{vh, vl, sidx, gid, rsrc, x, y, n_x, m, g, k_pad, k_c, (k_pad + kLane - 1) / kLane,
              wr, bps, xmode, step, win_rows};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(depth == 4   ? window_df_launch_d<4>(a, nblocks, csize, smem, st)
               : depth == 2 ? window_df_launch_d<2>(a, nblocks, csize, smem, st)
                            : window_df_launch_d<1>(a, nblocks, csize, smem, st));
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
