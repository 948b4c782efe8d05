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
// (all paths under spmv_openmp_cuda_tpu/), and the XLA-level steps of that
// package's routed df product (formats/routed.py::_routed_df_32,
// routed_spmv_df), which the TPU runs as fused XLA ops:
//   routed_df_split_kernel          <- ops/dfloat.py::split_f64_jnp (:101)
//   routed_df_reduce_kernel  (C-df) <- _reduce_runs_df (:1890) over
//                              apply_permutation's slab (ops/route.py)
//   routed_df_permute_kernel        <- the output permutation of both planes
//                              (ops/route.py::_whole_w_call :347 per plane)
//                              and df_combine64
//   routed_df_rowdot_kernel  (D-df) <- _df_dense_rowdot (:1962).
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
//   - dia_df_kernel: one launch per product. It takes x in f64 and splits
//     each element it reads exactly as ops/dfloat.py::split_f64_t does,
//     and writes y (m rows) in f64 as hi + lo (df_combine64), so the
//     wrapper neither splits x nor combines y. A thread owns R = 4
//     consecutive rows (R = 1 where four rows a thread would give fewer
//     CTAs than the card has SMs: ops/spmv_cuda.py::rows_a_thread) and
//     adds each row's diagonals in ascending offset order with df_mul_acc:
//     each row has one owner and its plain version's order of adds, so y
//     is bitwise the same for either R. Each diagonal's four (hi, lo) words are
//     two 16-byte loads streamed past L1 (slab_rows.cuh); x is read through
//     the read-only path, a thread's four values from two or three aligned
//     16-byte vectors (x_split4), behind a bounds test to the end of x (the
//     TPU window's clip of x at (S + pad_sub)*128 is not copied).
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
//   - the routed df product is a program of launches built once per
//     prepared matrix (routed_cuda.py::build_df_chain) and enqueued by
//     routed_df_chain_launch in one host call, the kernels' one entry point
//     (each single-kernel wrapper runs a one-op program; it counts the
//     launches it made): the split of x into its planes where a domain has
//     dense heavy rows, then per domain K3, C-df per level, the output
//     gather, D-df for the dense heavy rows: 6 launches on caida_like. The
//     products and sums are (hi, lo) pairs side by side in the scratch, so
//     that a scattered read of a pair is one 8-byte load (one L2 sector, not
//     one per plane). Every
//     permutation is composed at build time into int32 offsets (routed_cuda.py
//     ::plan_map), read once per slab slot, as routed_spmv.cu's C and B read
//     theirs; y's bits are those of the stage-by-stage plain chain.
//   - routed_df_gather_kernel (K3): one thread per slot of the gather tiles
//     (coalesced value and index reads, x gathered by global column in f64
//     and split), pad tiles written as zeros. No W1: C-df reads the products
//     through the whole products permutation.
//   - routed_df_reduce_kernel (C-df): routed_spmv.cu's C with pairs: a
//     one-warp CTA per (chunk of groups, band of 32 lanes), each lane's
//     offsets loaded a batch ahead of its (hi, lo) values. The plain versions
//     sum a group's rows padded with +0 pairs to a power of two by rounds of
//     adjacent-pair TwoSums; a lane streams its rows into a binary counter of
//     partial sums (DfStack), which adds the same pairs in the same order,
//     and closes the padded tree from the counter's levels. The pads keep the
//     plain versions' bits: the JAX package's halve tree passes an odd row up
//     unpadded, which differs only in the sign of a zero word.
//   - routed_df_permute_kernel: routed_spmv.cu's B over the pairs, writing
//     y in f64 as hi + lo (df_combine64).
//   - routed_df_rowdot_kernel (D-df): CTAs of 512 threads, as many per heavy
//     row as make ~256 in all (two per SM: 32 for each of caida_like's 8
//     rows), four residues of the row's padded columns a thread, a warp's
//     residues contiguous; a close kernel adds a row's CTAs. Bound: the
//     (hi, lo) block, 12.3 MB on caida_like.
#include "slab_rows.cuh"
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

// ---- DIA ------------------------------------------------------------------

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

// x[col .. col+3] split as x_split splits each. Where the four lie inside x
// and x is 16-byte aligned they come from the aligned double2 vectors that
// hold them: two where col is even, else three (col % 2 is the same for
// every thread of a warp, whose first rows are multiples of 4); else one by
// one.
__device__ __forceinline__ void x_split4(const double* __restrict__ x, long long col,
                                         long long n_x, bool x16, float (&h)[4], float (&l)[4]) {
  const long long a = col & ~1LL;
  const bool odd = col & 1;
  if (x16 && a >= 0 && a + (odd ? 6 : 4) <= n_x) {
    const double2 p = __ldg(reinterpret_cast<const double2*>(x + a));
    const double2 q = __ldg(reinterpret_cast<const double2*>(x + a + 2));
    double v[4];
    if (odd) {
      const double2 r = __ldg(reinterpret_cast<const double2*>(x + a + 4));
      v[0] = p.y; v[1] = q.x; v[2] = q.y; v[3] = r.x;
    } else {
      v[0] = p.x; v[1] = p.y; v[2] = q.x; v[3] = q.y;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = (float)v[k];
      l[k] = (float)(v[k] - (double)h[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x_split(x, col + k, n_x, h[k], l[k]);
  }
}

// y[i] (f64) = sum_d (dh, dl)[d, i] * x[i + offsets[d]], combined as hi +
// lo, for the R rows i0 .. i0+R-1 of this thread that are < m: each row's
// pair summed by df_mul_acc in ascending offset order from (0, 0); rows is
// the slab's row stride (s_pad * 128); x16: x is 16-byte aligned
// (x_split4's vector reads)
template <int R>
__global__ void __launch_bounds__(kThreads)
dia_df_kernel(const float* __restrict__ dh, const float* __restrict__ dl,
              const int* __restrict__ offsets, int n_diag, long long rows, long long m,
              const double* __restrict__ x, long long n_x, bool x16, double* __restrict__ y) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * R;
  if (i0 >= m) return;
  float ah[R], al[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ah[r] = al[r] = 0.f;
  const float* ph = dh + i0;
  const float* pl = dl + i0;
#pragma unroll 2
  for (int d = 0; d < n_diag; ++d, ph += rows, pl += rows) {
    float vh[R], vl[R];
    slab::rows<R>(ph, vh);
    slab::rows<R>(pl, vl);
    const long long col = i0 + __ldg(offsets + d);
    float xh[R], xl[R];
    if constexpr (R == 4)
      x_split4(x, col, n_x, x16, xh, xl);
    else
      x_split(x, col, n_x, xh[0], xl[0]);
#pragma unroll
    for (int r = 0; r < R; ++r) df_mul_acc(ah[r], al[r], vh[r], vl[r], xh[r], xl[r]);
  }
  double out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = (double)ah[r] + (double)al[r];
  if constexpr (R == 4) {
    if (i0 + 4 <= m) {
      double2* y2 = reinterpret_cast<double2*>(y + i0);
      y2[0] = make_double2(out[0], out[1]);
      y2[1] = make_double2(out[2], out[3]);
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r < m) y[i0 + r] = out[r];
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
  stage_x(xd, a.x, 0LL, a.n_x, x_base * kLane, a.win_rows * kLane, bar);
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

// ---- routed ----------------------------------------------------------------

constexpr int kBand = 32;          // lanes per CTA of C-df (one warp)
constexpr int kReduceBatch = 16;   // C-df: slab rows whose loads a thread issues together
constexpr int kChunkGroups = 128;  // C-df: at most this many groups per CTA (routed_cuda.py)
constexpr int kPermBatch = 4;      // the output gather: elements whose loads a thread issues together
constexpr int kReduceLevels = 7;   // C-df: groups of at most 128 = 2^7 rows
constexpr int kRowdotCta = 512;    // D-df: threads per CTA at most
constexpr int kRowdotVec = 4;      // D-df: adjacent residues a thread owns (a float4 per array)
constexpr int kRowdotBlock = 4;    // D-df: a residue's columns summed per static subtree
constexpr int kRowdotLevels = 15;  // D-df: a residue has at most 2^15 columns
constexpr int kMaxRowdotGroups = 32;  // D-df: CTAs per row at most

// A binary counter of partial sums: while bit k of n (the rows pushed so far)
// is set, level k holds the df sum of 2^k consecutive rows. Pushing a row
// TwoSum-adds it to the partial sums of equal size as they meet, the earlier
// rows on the left, so that 2^j rows pushed in order are summed by the
// complete binary tree over them: the adjacent-pair rounds of the plain
// versions. Level 0 lives in registers, levels 1.. in memory at mem[(k - 1)
// * kStride] (shared memory of a warp's lanes, or a thread's local array),
// so that a push is a short loop whatever the depth.
template <int kStride>
struct DfStack {
  float h0, l0;
  float2* mem;

  // push (vh, vl) as row n; on return (vh, vl) is the partial sum it stored
  // (after the push of row 2^j - 1, the sum of all 2^j rows)
  __device__ __forceinline__ void push(int n, float& vh, float& vl) {
    if (!(n & 1)) {
      h0 = vh;
      l0 = vl;
      return;
    }
    df_add(h0, l0, vh, vl);
    vh = h0;
    vl = l0;
    int k = 0;
    for (n >>= 1; n & 1; n >>= 1, ++k) {
      float2 t = mem[k * kStride];
      df_add(t.x, t.y, vh, vl);
      vh = t.x;
      vl = t.y;
    }
    mem[k * kStride] = make_float2(vh, vl);
  }

  // push the partial sum of 2^L rows (L >= 1) as rows n .. n + 2^L - 1, n a
  // multiple of 2^L: the adds of pushing those rows one by one, past the
  // ones among them
  __device__ __forceinline__ void push_block(int n, int L, float& vh, float& vl) {
    int k = L - 1;
    for (n >>= L; n & 1; n >>= 1, ++k) {
      float2 t = mem[k * kStride];
      df_add(t.x, t.y, vh, vl);
      vh = t.x;
      vl = t.y;
    }
    mem[k * kStride] = make_float2(vh, vl);
  }

  // level k's partial sum
  __device__ __forceinline__ float2 at(int k) const {
    return k ? mem[(k - 1) * kStride] : make_float2(h0, l0);
  }
};

// the complete binary tree over kN pairs (kN a power of two), by rounds of
// adjacent-pair TwoSums (the first round's kN/2 adds are independent): the
// sum lands in (h[0], l[0])
template <int kN>
__device__ __forceinline__ void df_tree(float (&h)[kN], float (&l)[kN]) {
#pragma unroll
  for (int s = 1; s < kN; s *= 2) {
#pragma unroll
    for (int i = 0; i < kN; i += 2 * s) df_add(h[i], l[i], h[i + s], l[i + s]);
  }
}

// tile i < n_real, slot (s, l): out[i*128 + s, l] = the (hi, lo) pair of
// (vh, vl)[i*128 + s, l] * x[widx[i]*16384 + pidx[i*128 + s, l]*128 + s], x
// read in f64 and split as ops/dfloat.py::split_f64_t splits it (one 8-byte
// gather per slot); tiles i >= n_real zero
__global__ void __launch_bounds__(kThreads)
routed_df_gather_kernel(const float* __restrict__ vh, const float* __restrict__ vl,
                        const int8_t* __restrict__ pidx, const int32_t* __restrict__ widx,
                        int n_real, long long n_elems, const double* __restrict__ x,
                        long long n_x, float2* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_elems) return;
  const long long tile = e / kWindowElems;
  if (tile >= n_real) {
    out[e] = make_float2(0.f, 0.f);
    return;
  }
  const int s = (int)((e / kLane) % kLane);
  const long long col = (long long)__ldg(widx + tile) * kWindowElems + (long long)pidx[e] * kLane + s;
  float gh, gl, ph, pl;
  x_split(x, col, n_x, gh, gl);
  df_prod(vh[e], vl[e], gh, gl, ph, pl);
  out[e] = make_float2(ph, pl);
}

// x (f64, length n) split into its (hi, lo) planes as ops/dfloat.py::
// split_f64_t splits it, each plane zero from n to its length n_plane (a
// multiple of 64): once per product, for D-df, which reads x at every column
// of each heavy row, four elements of a plane at a time (a conversion from
// f64 runs at a fraction of the f32 rate)
__global__ void __launch_bounds__(kThreads)
routed_df_split_kernel(const double* __restrict__ x, long long n, long long n_plane,
                       float* __restrict__ xh, float* __restrict__ xl) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_plane) return;
  float h, l;
  x_split(x, i, n, h, l);
  xh[i] = h;
  xl[i] = l;
}

// C-df's offsets (and, with kMask, mask) of rows [k0, k0 + kReduceBatch) of a
// chunk of n rows at lane l; rows past the chunk read as offset -1
template <bool kMask>
__device__ __forceinline__ void df_reduce_batch(const int32_t* __restrict__ off_l,
                                                const float* __restrict__ mask_l, int k0, int n,
                                                int (&o)[kReduceBatch],
                                                float (&mk)[kReduceBatch]) {
#pragma unroll
  for (int u = 0; u < kReduceBatch; ++u) {
    const bool in = k0 + u < n;
    o[u] = in ? __ldg(off_l + (long long)(k0 + u) * kLane) : -1;
    if (kMask) mk[u] = in ? __ldg(mask_l + (long long)(k0 + u) * kLane) : 0.f;
  }
}

// C-df: out[g, l] = the (hi, lo) df sum of the group's slab slots at lane l,
// slot (rr, l) = (mask ? mask[rr, l] : 1) * src[off[rr, l]] (the (hi, lo)
// pair, one 8-byte load; +0 where off is -1; both words masked by
// __fmul_rn), the group's w rows padded
// with +0 pairs to the power of two p2 >= w and summed by the complete binary
// tree over them (routed_cuda.py::reduce_runs_df). groups[g] = (row0, width).
// CTA 4c + b, one warp, takes lanes 32b .. 32b + 31 of chunk c = (row0, row1,
// g0, g1): lane l streams the chunk's rows in batches (offsets ahead of the
// values, as routed_spmv.cu's C), pushing each into a DfStack and closing
// each group at its last row. The pads are not pushed: a TwoSum-add of a +0
// pair on either side gives the other pair with each word plus +0 (a -0 word
// turns +0, nothing else changes), so the padded tree's top is the stack's
// partial sums (the levels of w's bits) added from the lowest up, the lowest
// plus +0 first.
template <bool kMask>
__global__ void __launch_bounds__(kBand)
routed_df_reduce_kernel(const float2* __restrict__ src, const int32_t* __restrict__ off,
                        const float* __restrict__ mask, const int2* __restrict__ groups,
                        const int4* __restrict__ chunks, float2* __restrict__ out) {
  constexpr int kBands = kLane / kBand;
  __shared__ int ends[kChunkGroups];  // each group's last row + 1, from the chunk's first row
  __shared__ float2 levels[kReduceLevels][kBand];  // the lanes' stack levels 1..
  const int4 ch = chunks[blockIdx.x / kBands];
  const int l = (blockIdx.x % kBands) * kBand + threadIdx.x;
  const int n = ch.y - ch.x;
  const long long e0 = (long long)ch.x * kLane + l;
  const int32_t* off_l = off + e0;
  const float* mask_l = kMask ? mask + e0 : nullptr;
  int o[kReduceBatch];
  float mk[kReduceBatch];
  df_reduce_batch<kMask>(off_l, mask_l, 0, n, o, mk);
  for (int j = threadIdx.x; j < ch.w - ch.z; j += kBand) {
    const int2 g = groups[ch.z + j];
    ends[j] = g.x + g.y - ch.x;
  }
  __syncthreads();
  int g = ch.z, begin = 0, end = ends[0], cnt = 0;
  DfStack<kBand> st;
  st.mem = &levels[0][threadIdx.x];
  // close group g, whose last push (or block push) returned (h, lo)
  auto close = [&](float h, float lo) {
    const int w = end - begin;
    if (w & (w - 1)) {  // padded: the tree's top over the levels of w's bits
      bool first = true;
      for (int k = 0; (1 << k) <= w; ++k) {
        if (!((w >> k) & 1)) continue;
        float2 t = st.at(k);
        if (first) {
          h = __fadd_rn(t.x, 0.f);
          lo = __fadd_rn(t.y, 0.f);
          first = false;
        } else {
          df_add(t.x, t.y, h, lo);
          h = t.x;
          lo = t.y;
        }
      }
    }  // else (h, lo) is the whole tree's sum
    out[(long long)g * kLane + l] = make_float2(h, lo);
    cnt = 0;
    begin = end;
    if (++g < ch.w) end = ends[g - ch.z];
  };
  for (int k0 = 0; k0 < n; k0 += kReduceBatch) {
    float vh[kReduceBatch], vl[kReduceBatch];
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      const float2 v = o[u] >= 0 ? __ldg(src + o[u]) : make_float2(0.f, 0.f);
      vh[u] = v.x;
      vl[u] = v.y;
      if (kMask) {
        vh[u] = __fmul_rn(vh[u], mk[u]);
        vl[u] = __fmul_rn(vl[u], mk[u]);
      }
    }
    // the next batch's offsets travel while this batch's values do
    df_reduce_batch<kMask>(off_l, mask_l, k0 + kReduceBatch, n, o, mk);
    if (k0 + kReduceBatch <= end && cnt % kReduceBatch == 0) {
      // a whole aligned block of the group's rows: its subtree, then one push
      df_tree<kReduceBatch>(vh, vl);
      st.push_block(cnt, 4, vh[0], vl[0]);
      cnt += kReduceBatch;
      if (k0 + kReduceBatch == end) close(vh[0], vl[0]);
      continue;
    }
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      if (k0 + u >= n) break;
      float h = vh[u], lo = vl[u];
      st.push(cnt++, h, lo);
      if (k0 + u + 1 == end) close(h, lo);
    }
  }
}

// The output gather: y[i] = (double)hi + (double)lo of the pair src[map[i]]
// (+0 where map[i] is -1) for i < n: a domain's output permutation of the
// (hi, lo) sums in one gather, combined into f64 as df_combine64 does.
// Thread t of CTA b takes i = b*kThreads*kPermBatch + u*kThreads + t, its map
// loads, then its value loads, then its stores (routed_spmv.cu's B).
__global__ void __launch_bounds__(kThreads)
routed_df_permute_kernel(const float2* __restrict__ src, const int32_t* __restrict__ map,
                         long long n, double* __restrict__ y) {
  const long long i0 = (long long)blockIdx.x * (kThreads * kPermBatch) + threadIdx.x;
  int o[kPermBatch];
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) {
    const long long i = i0 + (long long)u * kThreads;
    o[u] = i < n ? __ldg(map + i) : -1;
  }
  float2 v[kPermBatch];
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) v[u] = o[u] >= 0 ? __ldg(src + o[u]) : make_float2(0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) {
    const long long i = i0 + (long long)u * kThreads;
    if (i < n) y[i] = (double)v[u].x + (double)v[u].y;
  }
}

// The dense heavy rows' operands (routed_cuda.py::DFRowdotStage).
struct RowdotArgs {
  const float* hh;      // (n_h, n_pad) hi words
  const float* hl;      // lo words
  const int32_t* rows;  // (n_h,) rows of y
  double* y;
  const float* xh;      // x's (hi, lo) planes, zero from n_x to n_plane
  const float* xl;
  long long n_plane;  // a multiple of 64 (routed_df_split_kernel)
  long long n_pad;
  float* part;  // groups > 1: each (row, CTA, lane)'s four (hi, lo) pairs, 8 floats
  int log_k;    // log2 of the columns per residue: p2 = 2^log_k * residues per row
  int groups;   // CTAs per row, a power of two
};

// D-df: y[rows[k]] = (double)hi + (double)lo of heavy row k's df dot with x
// (its (hi, lo) planes): the products (a TwoProduct and the cross terms) of
// the columns padded with +0 pairs to p2 = 2^log_k * P, summed by the halving
// tree (column c with c + p2/2, ..., routed_cuda.py::df_dense_rowdot, the JAX
// package's _df_dense_rowdot). Residue v < P owns the columns v + P*k.
// Residues come in quads 4q .. 4q + 3, one per thread (one float4 of each of
// hh, hl, xh and xl per column step, four independent sums in flight), and a
// row is `groups` CTAs: lane l of warp w of CTA g takes quad q = l + 32*(g +
// groups*w), so that a warp reads 512 contiguous bytes of each array, the
// CTAs of all rows spread over the SMs with no cluster to co-schedule, and
// the tree's levels over the quads pair, in turn, warps of one CTA (q with q
// + 32*groups*half), CTAs (g with g + half) and lanes (l with l + half),
// then a quad's own residues (i with i + 2, then 0 with 1). The first
// log_k levels pair columns of one residue: over k they are the
// adjacent-pair rounds of the bit-reversed sequence, so a residue's columns
// stream in bit-reversed k order, an aligned block of 4 at a time (a static
// subtree, then one push into a DfStack whose levels sit in a local array).
// The warps meet in shared memory; where groups > 1 each CTA leaves its 32
// quads in part and routed_df_rowdot_close_kernel adds the rest, else the
// lanes meet by shuffles here. Each pairing is fixed, so a rerun is bitwise
// equal. Padded columns go through the same TwoSums as +0 pairs. Bound: the
// block's bytes, with ~20 f32 instructions a column close behind.
__global__ void __launch_bounds__(kRowdotCta, 2)
routed_df_rowdot_kernel(RowdotArgs a) {
  constexpr int V = kRowdotVec, B = kRowdotBlock;
  __shared__ float4 red_h[kRowdotCta], red_l[kRowdotCta];
  const int nt = blockDim.x, tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const long long row = blockIdx.x / a.groups;
  const int g = (int)(blockIdx.x % a.groups);
  const long long P = (long long)nt * V * a.groups;
  const long long c_t = (lane + 32 * (g + (long long)a.groups * w)) * V;  // the quad's first residue
  const float* hh = a.hh + row * a.n_pad;
  const float* hl = a.hl + row * a.n_pad;
  const int K = 1 << a.log_k;
  float2 levels[V][kRowdotLevels];
  DfStack<1> st[V];
#pragma unroll
  for (int i = 0; i < V; ++i) st[i].mem = levels[i];
  float h[V], lo[V];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < K; j0 += B) {
    // columns c_t + P*rev(j0 + u) (rev over log_k bits) .. + 3; a block past
    // K or columns past n_pad load +0 pairs, whose products are (+0, +0)
    float4 vh[B], vl[B], gh[B], gl[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int j = j0 + u;
      const unsigned k = a.log_k ? __brev((unsigned)j) >> (32 - a.log_k) : 0u;
      const long long c = c_t + P * k;
      const bool in = j < K && c < a.n_pad;
      vh[u] = in ? __ldcg(reinterpret_cast<const float4*>(hh + c)) : zero;
      vl[u] = in ? __ldcg(reinterpret_cast<const float4*>(hl + c)) : zero;
      const bool xin = in && c < a.n_plane;
      gh[u] = xin ? __ldcg(reinterpret_cast<const float4*>(a.xh + c)) : zero;
      gl[u] = xin ? __ldcg(reinterpret_cast<const float4*>(a.xl + c)) : zero;
    }
    float ph[V][B], pl[V][B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      df_prod(vh[u].x, vl[u].x, gh[u].x, gl[u].x, ph[0][u], pl[0][u]);
      df_prod(vh[u].y, vl[u].y, gh[u].y, gl[u].y, ph[1][u], pl[1][u]);
      df_prod(vh[u].z, vl[u].z, gh[u].z, gl[u].z, ph[2][u], pl[2][u]);
      df_prod(vh[u].w, vl[u].w, gh[u].w, gl[u].w, ph[3][u], pl[3][u]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (K >= B) {  // an aligned block of j: its subtree, one push
        df_tree<B>(ph[i], pl[i]);
        h[i] = ph[i][0];
        lo[i] = pl[i][0];
        st[i].push_block(j0, 2, h[i], lo[i]);
      } else {
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (u >= K) break;
          h[i] = ph[i][u];
          lo[i] = pl[i][u];
          st[i].push(u, h[i], lo[i]);
        }
      }
    }
  }
  // (h[i], lo[i]): residue c_t + i's columns summed. Warps w and w + half
  // pair (quads q and q + 32*groups*half), half = nt/64 .. 1
  red_h[tid] = make_float4(h[0], h[1], h[2], h[3]);
  red_l[tid] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  for (int half = nt / 64; half >= 1; half /= 2) {
    __syncthreads();
    if (w < half) {
      const float4 oh = red_h[tid + 32 * half], ol = red_l[tid + 32 * half];
      df_add(h[0], lo[0], oh.x, ol.x);
      df_add(h[1], lo[1], oh.y, ol.y);
      df_add(h[2], lo[2], oh.z, ol.z);
      df_add(h[3], lo[3], oh.w, ol.w);
      red_h[tid] = make_float4(h[0], h[1], h[2], h[3]);
      red_l[tid] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  if (w != 0) return;
  if (a.groups > 1) {  // the CTA's 32 quads, for the close
    float4* o = reinterpret_cast<float4*>(a.part + ((row * a.groups + g) * 32 + lane) * 2 * V);
    o[0] = make_float4(h[0], h[1], h[2], h[3]);
    o[1] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    return;
  }
  for (int half = 16; half >= 1; half /= 2) {
    float oh[V], ol[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      oh[i] = __shfl_down_sync(0xffffffffu, h[i], half);
      ol[i] = __shfl_down_sync(0xffffffffu, lo[i], half);
    }
    if (lane < half) {
#pragma unroll
      for (int i = 0; i < V; ++i) df_add(h[i], lo[i], oh[i], ol[i]);
    }
  }
  if (lane == 0) {
    df_add(h[0], lo[0], h[2], lo[2]);
    df_add(h[1], lo[1], h[3], lo[3]);
    df_add(h[0], lo[0], h[1], lo[1]);
    a.y[__ldg(a.rows + row)] = (double)h[0] + (double)lo[0];
  }
}

// D-df's close where a row is several CTAs: a CTA of 32*groups threads per
// row, thread (g, l) holding CTA g's quad at lane l; the CTAs pair in
// shared memory (g with g + half, half = groups/2 .. 1), then warp 0's lanes
// by shuffles (l with l + half), then the quad's four residues (i with i + 2,
// then 0 with 1), and lane 0 writes y.
__global__ void __launch_bounds__(32 * kMaxRowdotGroups)
routed_df_rowdot_close_kernel(const float* __restrict__ part, int groups,
                              const int32_t* __restrict__ rows, double* __restrict__ y) {
  constexpr int V = kRowdotVec;
  __shared__ float4 red_h[32 * kMaxRowdotGroups], red_l[32 * kMaxRowdotGroups];
  const int row = blockIdx.x, tid = threadIdx.x, g = tid / 32, lane = tid % 32;
  const float4* o = reinterpret_cast<const float4*>(part + ((long long)row * groups * 32 + tid) * 2 * V);
  float4 vh = o[0], vl = o[1];
  float h[V] = {vh.x, vh.y, vh.z, vh.w}, lo[V] = {vl.x, vl.y, vl.z, vl.w};
  red_h[tid] = vh;
  red_l[tid] = vl;
  for (int half = groups / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (g < half) {
      const float4 oh = red_h[tid + 32 * half], ol = red_l[tid + 32 * half];
      df_add(h[0], lo[0], oh.x, ol.x);
      df_add(h[1], lo[1], oh.y, ol.y);
      df_add(h[2], lo[2], oh.z, ol.z);
      df_add(h[3], lo[3], oh.w, ol.w);
      red_h[tid] = make_float4(h[0], h[1], h[2], h[3]);
      red_l[tid] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  if (g != 0) return;
  for (int half = 16; half >= 1; half /= 2) {
    float oh[V], ol[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      oh[i] = __shfl_down_sync(0xffffffffu, h[i], half);
      ol[i] = __shfl_down_sync(0xffffffffu, lo[i], half);
    }
    if (lane < half) {
#pragma unroll
      for (int i = 0; i < V; ++i) df_add(h[i], lo[i], oh[i], ol[i]);
    }
  }
  if (lane == 0) {
    df_add(h[0], lo[0], h[2], lo[2]);
    df_add(h[1], lo[1], h[3], lo[3]);
    df_add(h[0], lo[0], h[1], lo[1]);
    y[__ldg(rows + row)] = (double)h[0] + (double)lo[0];
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// ---- the routed df program (routed_df_chain_launch) -----------------------

int df_split_launch(const double* x, long long n, long long n_plane, float* xh, float* xl,
                    cudaStream_t st) {
  if (n_plane < n || n_plane % 64) return (int)cudaErrorInvalidValue;
  if (n_plane < 1) return 0;
  routed_df_split_kernel<<<blocks_for(n_plane), kThreads, 0, st>>>(x, n, n_plane, xh, xl);
  return (int)cudaGetLastError();
}

int df_gather_launch(const float* vh, const float* vl, const int8_t* pidx, const int32_t* widx,
                     int n_real, int n_tiles, const double* x, long long n_x, float2* out,
                     cudaStream_t st) {
  const long long n = (long long)n_tiles * kWindowElems;
  routed_df_gather_kernel<<<blocks_for(n), kThreads, 0, st>>>(vh, vl, pidx, widx, n_real, n, x,
                                                              n_x, out);
  return (int)cudaGetLastError();
}

// a one-warp CTA per (chunk, band of 32 lanes)
int df_reduce_launch(const float2* src, const int32_t* off, const float* mask,
                     const int32_t* groups, const int32_t* chunks, int n_chunks, float2* out,
                     cudaStream_t st) {
  const unsigned grid = (unsigned)n_chunks * (kLane / kBand);
  const int2* g = reinterpret_cast<const int2*>(groups);
  const int4* c = reinterpret_cast<const int4*>(chunks);
  if (mask != nullptr) {
    routed_df_reduce_kernel<true><<<grid, kBand, 0, st>>>(src, off, mask, g, c, out);
  } else {
    routed_df_reduce_kernel<false><<<grid, kBand, 0, st>>>(src, off, mask, g, c, out);
  }
  return (int)cudaGetLastError();
}

int df_permute_launch(const float2* src, const int32_t* map, long long n, double* y,
                      cudaStream_t st) {
  const long long per_cta = (long long)kThreads * kPermBatch;
  routed_df_permute_kernel<<<(unsigned)((n + per_cta - 1) / per_cta), kThreads, 0, st>>>(
      src, map, n, y);
  return (int)cudaGetLastError();
}

// n_h rows, each `groups` CTAs of cta threads (routed_cuda.py::rowdot_plan):
// cta a power of two from 32 to 512 (512 where groups > 1), groups a power
// of two up to 32, and cta * groups * 4 * 2^log_k the power of two of n_pad;
// then the close where groups > 1 (part: n_h * groups * 32 * 8 floats of
// scratch)
int df_rowdot_launch(const RowdotArgs& a, int n_h, int cta, cudaStream_t st) {
  const long long cols = (long long)cta * a.groups * kRowdotVec << a.log_k;
  if (a.groups < 1 || a.groups > kMaxRowdotGroups || (a.groups & (a.groups - 1)) ||
      (a.groups > 1 && (cta != kRowdotCta || a.part == nullptr || ((uintptr_t)a.part & 15))) ||
      cta < 32 || cta > kRowdotCta || (cta & (cta - 1)) || a.n_plane % 64 || a.log_k < 0 ||
      a.log_k > kRowdotLevels || n_h < 1 ||
      cols < a.n_pad || cols >= 2 * a.n_pad ||  // cols: the power of two of n_pad
      a.n_pad % kRowdotVec ||
      (((uintptr_t)a.hh | (uintptr_t)a.hl | (uintptr_t)a.xh | (uintptr_t)a.xl) & 15))
    return (int)cudaErrorInvalidValue;
  routed_df_rowdot_kernel<<<(unsigned)((long long)n_h * a.groups), cta, 0, st>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || a.groups == 1) return rc;
  routed_df_rowdot_close_kernel<<<(unsigned)n_h, 32 * a.groups, 0, st>>>(a.part, a.groups, a.rows,
                                                                         a.y);
  return (int)cudaGetLastError();
}

// Program operands: a pointer is tagged in its top byte: 0 = absolute
// address (0 itself = null), 1 = scratch + offset, 2 = y + offset (byte
// offsets in the low 56 bits), as in routed_spmv.cu.
void* resolve(long long v, char* scratch, char* y) {
  const unsigned long long u = (unsigned long long)v;
  const long long off = (long long)(u & ((1ULL << 56) - 1));
  switch (u >> 56) {
    case 1: return scratch + off;
    case 2: return y + off;
    default: return (void*)off;
  }
}

enum DfOp { kOpDfSplit = 1, kOpDfGather = 2, kOpDfReduce = 3, kOpDfPermute = 4, kOpDfRowdot = 5 };
constexpr int kDfOpWords[] = {0, 4, 8, 8, 5, 14};  // by op: the op and its operands

}  // namespace

extern "C" {

// y (f64, length m) = the diagonal sums over the (n_diag, rows) slab pair,
// x in f64, split in the kernel: rows >= m a multiple of 4, dh, dl and y
// 16-byte aligned, rows_a_thread 1 or 4 (ops/spmv_cuda.py::rows_a_thread).
// Returns cudaErrorInvalidValue for anything else, else cudaGetLastError()
// after the launch.
int dia_df_launch(const float* dh, const float* dl, const int* offsets, int n_diag,
                  long long rows, long long m, const double* x, long long n_x, double* y,
                  int rows_a_thread, void* stream) {
  if ((rows_a_thread != 1 && rows_a_thread != 4) || m < 1 || m > rows || rows % 4 ||
      (((uintptr_t)dh | (uintptr_t)dl | (uintptr_t)y) & 15))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = blocks_for((m + rows_a_thread - 1) / rows_a_thread);
  const bool x16 = ((uintptr_t)x & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_a_thread == 4)
    dia_df_kernel<4><<<grid, kThreads, 0, st>>>(dh, dl, offsets, n_diag, rows, m, x, n_x, x16, y);
  else
    dia_df_kernel<1><<<grid, kThreads, 0, st>>>(dh, dl, offsets, n_diag, rows, m, x, n_x, x16, y);
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

// Runs the len-entry program prog (ops with their operands, see
// routed_cuda.py::_df_op) on the stream: the split of x (f64, length n_x)
// into its (hi, lo) planes, K3 (the df gather), C-df (the df reduce), the
// output gather and D-df (the dense heavy rows); y is f64. counts[0..4]
// (host memory) gains one for each op of these five that was enqueued
// without error. Returns the first error, or 0; nothing after it is enqueued.
int routed_df_chain_launch(const long long* prog, int len, const double* x, long long n_x,
                           double* y, void* scratch, int* counts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto P = [&](int i) { return resolve(prog[i], (char*)scratch, (char*)y); };
  int i = 0;
  while (i < len) {
    const long long op = prog[i];
    if (op < kOpDfSplit || op > kOpDfRowdot || i + kDfOpWords[op] > len)
      return (int)cudaErrorInvalidValue;
    int rc;
    switch ((int)op) {
      case kOpDfSplit:  // xh xl n_plane
        rc = df_split_launch(x, n_x, prog[i + 3], (float*)P(i + 1), (float*)P(i + 2), st);
        break;
      case kOpDfGather:  // vals vals_lo pidx widx n_real n_tiles out
        rc = df_gather_launch((const float*)P(i + 1), (const float*)P(i + 2),
                              (const int8_t*)P(i + 3), (const int32_t*)P(i + 4), (int)prog[i + 5],
                              (int)prog[i + 6], x, n_x, (float2*)P(i + 7), st);
        break;
      case kOpDfReduce:  // src off mask groups chunks n_chunks out
        rc = df_reduce_launch((const float2*)P(i + 1), (const int32_t*)P(i + 2),
                              (const float*)P(i + 3), (const int32_t*)P(i + 4),
                              (const int32_t*)P(i + 5), (int)prog[i + 6], (float2*)P(i + 7), st);
        break;
      case kOpDfPermute:  // src map n y
        rc = df_permute_launch((const float2*)P(i + 1), (const int32_t*)P(i + 2), prog[i + 3],
                               (double*)P(i + 4), st);
        break;
      case kOpDfRowdot: {  // hh hl rows y n_h n_pad log_k cta xh xl n_plane groups part
        RowdotArgs a;
        a.hh = (const float*)P(i + 1);
        a.hl = (const float*)P(i + 2);
        a.rows = (const int32_t*)P(i + 3);
        a.y = (double*)P(i + 4);
        a.n_pad = prog[i + 6];
        a.log_k = (int)prog[i + 7];
        a.xh = (const float*)P(i + 9);
        a.xl = (const float*)P(i + 10);
        a.n_plane = prog[i + 11];
        a.groups = (int)prog[i + 12];
        a.part = (float*)P(i + 13);
        rc = df_rowdot_launch(a, (int)prog[i + 5], (int)prog[i + 8], st);
        break;
      }
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
    ++counts[op - 1];
    i += kDfOpWords[op];
  }
  return 0;
}

const char* df_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
