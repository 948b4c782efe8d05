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
//   routed_df_reduce_kernel  (C-df) <- formats/routed.py::_gather_products_df
//                              (:1882): level 0 forms K3's products itself
// (all paths under spmv_openmp_cuda_tpu/), and the XLA-level steps of that
// package's routed df product (formats/routed.py::_routed_df_32,
// routed_spmv_df), which the TPU runs as fused XLA ops:
//   routed_df_reduce_kernel  (C-df) <- _reduce_runs_df (:1890) over
//                              apply_permutation's slab (ops/route.py)
//   routed_df_permute_kernel        <- the output permutation of both planes
//                              (ops/route.py::_whole_w_call :347 per plane)
//                              and df_combine64, of every domain
//                              (routed_df_auto_spmv's chunks) at once
//   routed_df_rowdot_kernel  (D-df) <- _df_dense_rowdot (:1962), with
//                              ops/dfloat.py::split_f64_jnp (:101) of x.
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
//     launches it made): per domain C-df per level (level 0 forming K3's
//     products, and closing the one-tile level after it in its last CTAs),
//     each domain's sums in a region of the scratch of its own; then one
//     output gather for the whole product, whatever the number of domains;
//     then per domain D-df for the dense heavy rows (after the gather: it
//     overwrites those rows of y). 3 launches on caida_like, 11 on
//     webbase_like's five domains. The sums are (hi, lo) pairs side by side in the scratch, so
//     that a scattered read of a pair is one 8-byte load (one L2 sector, not
//     one per plane). Every permutation is composed at build time into int32
//     offsets (routed_cuda.py::plan_map), read once per slab slot, as
//     routed_spmv.cu's C and B read theirs; level 0's composes K3's operands
//     too (each slot's (hi, lo) value and x column). y's bits are those of
//     the stage-by-stage plain chain.
//   - routed_df_reduce_kernel (C-df): routed_spmv.cu's C with pairs: a
//     warp per task (a chunk of groups and a band of 32 lanes, or one block
//     of 32 rows of a wider group: routed_cuda.py::df_reduce_tasks),
//     kReduceWarps tasks a CTA, each lane's indices loaded a batch ahead of
//     its (hi, lo) values. What bounds it is each lane's chain of dependent
//     round trips, not bytes: a group of 128 rows was 16 batches in turn
//     on one warp; as 4 blocks on 4 warps of a CTA (their subtree sums
//     added in shared memory) it is 4. At level 0 a slot's value pair and x
//     column are read coalesced and x gathered in f64 by an asynchronous
//     copy one batch ahead, split and multiplied there: K3 and its
//     products' round trip through memory (written once, read once, an
//     8-byte pair per 32-byte sector) are gone. The plain versions sum a
//     group's rows padded with +0 pairs to a power of two by rounds of
//     adjacent-pair TwoSums; a lane streams its rows into a binary counter
//     of partial sums (DfStack), which adds the same pairs in the same
//     order, and closes the padded tree from the counter's levels. The pads
//     keep the plain versions' bits: the JAX package's halve tree passes an
//     odd row up unpadded, which differs only in the sign of a zero word. A
//     one-tile level after level 0 (caida_like's t = 1) costs a dependent
//     launch, not bytes: the CTAs that finish level 0 last run its sets,
//     after the last ticket (self-resetting counters); such a level is at
//     most 32 CTA-sets, so that its waiting closers stay few beside the
//     card's CTA slots (a larger one is refused).
//   - routed_df_permute_kernel: the output gather of every domain in one
//     launch, through one map composed at build time, writing y in f64 as
//     hi + lo (df_combine64): four adjacent rows a thread, 16-byte offset
//     loads and streaming 16-byte y stores.
//   - routed_df_rowdot_kernel (D-df): one launch per heavy block: CTAs of
//     256 threads over sets of residues (4 columns each where the width
//     allows) of a tile of up to 4 rows, a warp reading 512 contiguous
//     bytes of each plane, x read in f64 and split once per CTA for all its
//     rows and kept in registers (no split kernel, no planes in the
//     scratch); the rows run one after the other without a barrier, their
//     sums kept in shared memory, then added over the warps; each CTA
//     leaves 128 pairs per row, and the closing takes one or two steps of
//     up to 16 CTAs each, each by the last CTA to take a self-resetting
//     ticket (as routed_spmv.cu's D), reading them coalesced. Without its
//     closing steps the kernel took 5.8 us on caida_like's block (one
//     H100; torch.mv 7.3): they are about half of its time. Bound: the
//     (hi, lo) block, x once and y: 13.84 MB on caida_like.
#include "slab_rows.cuh"
#include "window_tile.cuh"

namespace {

using wtile::kLane;
using wtile::kThreads;
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

constexpr int kBand = 32;          // lanes per warp unit of C-df
constexpr int kReduceWarps = 4;    // C-df: warps (units) per CTA
constexpr int kReduceBatch = 16;   // C-df: slab rows whose loads a thread issues together
constexpr int kGatherBatch = 8;    // C-df level 0: the same, two batches ahead
constexpr int kCloseBatch = 32;    // C-df's closed level: the same (a tile of 128 rows at most)
constexpr int kMaxCloseSets = 32;  // C-df's closed level: CTA-sets at most (its closers wait at once)
constexpr int kChunkGroups = 128;  // C-df: at most this many groups per chunk (routed_cuda.py)
constexpr int kBlockRows = 32;     // C-df: rows of a block of a wider group (one warp's task)
constexpr int kPermBatch = 4;      // the output gather: adjacent rows a thread owns
constexpr int kReduceLevels = 7;   // C-df: groups of at most 128 = 2^7 rows
constexpr int kRowdotCta = 256;    // D-df: threads per CTA at most
constexpr int kRowdotVec = 4;      // D-df: adjacent residues a thread owns (a float4 per array)
constexpr int kRowdotBlock = 4;    // D-df: a residue's columns summed per static subtree
constexpr int kRowdotBlockLog = 2;  // log2(kRowdotBlock)
constexpr int kRowdotLevels = 15;  // D-df: a residue has at most 2^15 columns
constexpr int kRowdotTile = 4;     // D-df: rows a CTA takes at most (its row tile)
constexpr int kMaxRowdotGroups = 256;  // D-df: CTAs per row tile at most (two closing steps of 16)
constexpr int kRowdotStream = 16;  // D-df's close: CTAs' pairs a thread streams at most

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

// One level of C-df: its slab's slots and what they read. Level 0 (vals
// set; routed_cuda.py::DFGatherReduceStage) reads each slot's (hi, lo)
// value and its x column, K3's operands composed through the products
// permutation at build time, and forms K3's product where it sums it: x
// gathered in f64 through the read-only path and split by x_split, the
// product by df_prod, so each product has the bits K3 wrote (a slot that
// reads nothing holds (+0, +0) and column -1: its product is (+0, +0), the
// pair C-df read for it before). A later level (vals null) reads the (hi,
// lo) sums of the level before through one offset per slot (+0 where the
// offset is -1). Both words of a slot are masked by __fmul_rn where mask
// is set.
struct DfLevel {
  const float2* vals;  // level 0: (rows, 128) (hi, lo) values
  const int32_t* idx;  // level 0: x columns; a later level: offsets into src
  const float2* src;   // a later level: the sums of the level before
  const float* mask;   // null: no mask
  const int2* groups;  // (first slab row, width) per output group
  const int4* chunks;  // (row0, row1, g0, g1) per chunk (routed_cuda.py::reduce_chunks)
  const int4* tasks;   // (chunk, band, block, blocks) per warp, kReduceWarps a CTA (reduce_tasks)
  int n_tasks;
  float2* out;  // (n_groups, 128) (hi, lo) sums
};

// A warp's slot reads of rows [k0, k0 + NB) of a chunk of n rows at lane
// offset e0: the index (-1 past the chunk), the mask, and at level 0 the
// (hi, lo) value
template <int NB, bool kProducts, bool kMask>
__device__ __forceinline__ void df_reduce_batch(const DfLevel& lv, long long e0, int k0, int n,
                                                int (&o)[NB], float (&mk)[NB], float2 (&v)[NB]) {
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const bool in = k0 + u < n;
    const long long e = e0 + (long long)(k0 + u) * kLane;
    o[u] = in ? __ldg(lv.idx + e) : -1;
    if (kMask) mk[u] = in ? __ldg(lv.mask + e) : 0.f;
    if (kProducts) v[u] = in ? __ldg(lv.vals + e) : make_float2(0.f, 0.f);
  }
}

// x at a batch's columns in f64 into the lane's slots of xs (an
// asynchronous copy each: the wait is explicit, so the compiler cannot
// sink the gather to its use; +0 outside [0, n_x), x_split's zeros)
template <int NB>
__device__ __forceinline__ void df_gather_x(const double* __restrict__ x, long long n_x,
                                            const int (&o)[NB], double (*xs)[kBand]) {
  const int lane = threadIdx.x % kBand;
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const bool in = o[u] >= 0 && o[u] < n_x;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     wtile::smem_addr(&xs[u][lane])),
                 "l"(reinterpret_cast<uint64_t>(in ? x + o[u] : x)), "r"(in ? 8 : 0)
                 : "memory");
  }
  wtile::cp_async_commit();
}

// One task of a level, by one warp: chunk c's lanes 32b .. 32b + 31 (task
// (c, b, j, blocks)); out[g, l] = the (hi, lo) df sum of the group's slab
// slots at lane l, the group's w rows padded with +0 pairs to the power of
// two p2 >= w and summed by the complete binary tree over them
// (routed_cuda.py::reduce_runs_df). A chunk wider than kBlockRows rows holds
// one group; its aligned blocks of kBlockRows rows (complete subtrees of
// that tree) are tasks of their own (blocks > 1: block j), run by warps of
// one CTA, each leaving its block's subtree sum in bsum for
// df_combine_blocks. Lane l streams the rows in batches, pushing each into
// a DfStack and closing each group at its last row: a later level reads the
// next batch's offsets while this batch's sums travel (as routed_spmv.cu's
// C); level 0 reads a batch's indices and values two batches ahead and its
// x one batch ahead, so that each batch waits for one round trip, not the
// two of an index and then the x it names. The pads are not pushed: a
// TwoSum-add of a +0 pair on either side gives the other pair with each
// word plus +0 (a -0 word turns +0, nothing else changes), so the padded
// tree's top is the stack's partial sums (the levels of w's bits) added
// from the lowest up, the lowest plus +0 first; a block of fewer rows than
// kBlockRows adds one +0 pair more (its subtree's pads past its own power of
// two: after the first, a +0 pair changes nothing). kL2: the sums of the
// level before are read from L2 (__ldcg: another CTA of this launch wrote
// them), in batches of kCloseBatch. ends, levels and (level 0) xs, two
// stages of a batch's x: the warp's shared memory.
template <bool kProducts, bool kMask, bool kL2>
__device__ void df_reduce_unit(const DfLevel& lv, int4 tk, const double* __restrict__ x,
                               long long n_x, int* ends, float2 (*levels)[kBand],
                               double (*xs)[kGatherBatch][kBand], float2* bsum) {
  static_assert(!(kProducts && kMask), "level 0 has no mask");
  constexpr int NB = kProducts ? kGatherBatch : kL2 ? kCloseBatch : kReduceBatch;
  constexpr int LB = kProducts ? 3 : kL2 ? 5 : 4;  // log2(NB)
  static_assert(NB == 1 << LB && kBlockRows % NB == 0, "a batch is an aligned block");
  const int lane = threadIdx.x % kBand;
  const int4 ch = __ldg(lv.chunks + tk.x);
  const int l = tk.y * kBand + lane;
  const bool blk = tk.w > 1;
  const int r0 = blk ? ch.x + kBlockRows * tk.z : ch.x;
  const int n = blk ? min(kBlockRows, ch.y - r0) : ch.y - ch.x;
  const long long e0 = (long long)r0 * kLane + l;
  int o[NB];
  float mk[NB];
  float2 v[NB], vn[NB];
  df_reduce_batch<NB, kProducts, kMask>(lv, e0, 0, n, o, mk, v);
  if (kProducts) {
    df_gather_x<NB>(x, n_x, o, xs[0]);
    df_reduce_batch<NB, kProducts, kMask>(lv, e0, NB, n, o, mk, vn);
  }
  __syncwarp();  // the warp's previous task has read ends
  if (blk) {
    if (lane == 0) ends[0] = n;  // one group: the block's rows
  } else {
    for (int j = lane; j < ch.w - ch.z; j += kBand) {
      const int2 g = __ldg(lv.groups + ch.z + j);
      ends[j] = g.x + g.y - ch.x;
    }
  }
  __syncwarp();
  int g = ch.z, begin = 0, end = ends[0], cnt = 0;
  DfStack<kBand> st;
  st.mem = &levels[0][lane];
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
    if (!blk) {
      lv.out[(long long)g * kLane + l] = make_float2(h, lo);
    } else {
      if (w < kBlockRows) df_add(h, lo, 0.f, 0.f);  // the block's pads past its power of two
      bsum[lane] = make_float2(h, lo);
    }
    cnt = 0;
    begin = end;
    if (++g < ch.w) end = ends[g - ch.z];
  };
  for (int k0 = 0; k0 < n; k0 += NB) {
    float vh[NB], vl[NB];
    if (kProducts) {
      // o holds batch k0 + NB's indices, vn its values: its x, then batch
      // k0 + 2NB's indices and values, while this batch's products form
      const int b = (k0 / NB) & 1;
      df_gather_x<NB>(x, n_x, o, xs[b ^ 1]);
      float2 vnn[NB];
      df_reduce_batch<NB, kProducts, kMask>(lv, e0, k0 + 2 * NB, n, o, mk, vnn);
      wtile::cp_async_wait<1>();  // this batch's x (each lane reads its own slots)
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const double xv = xs[b][u][lane];
        const float gh = (float)xv;
        const float gl = (float)(xv - (double)gh);  // x_split's words
        df_prod(v[u].x, v[u].y, gh, gl, vh[u], vl[u]);
        v[u] = vn[u];
        vn[u] = vnn[u];
      }
    } else {
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const float2 s = o[u] < 0 ? make_float2(0.f, 0.f)
                                  : kL2 ? __ldcg(lv.src + o[u]) : __ldg(lv.src + o[u]);
        vh[u] = s.x;
        vl[u] = s.y;
        if (kMask) {
          vh[u] = __fmul_rn(vh[u], mk[u]);
          vl[u] = __fmul_rn(vl[u], mk[u]);
        }
      }
      // the next batch's offsets travel while this batch's sums do
      df_reduce_batch<NB, kProducts, kMask>(lv, e0, k0 + NB, n, o, mk, v);
    }
    if (k0 + NB <= end && cnt % NB == 0) {
      // a whole aligned block of the group's rows: its subtree, then one push
      df_tree<NB>(vh, vl);
      st.push_block(cnt, LB, vh[0], vl[0]);
      cnt += NB;
      if (k0 + NB == end) close(vh[0], vl[0]);
      continue;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (k0 + u >= n) break;
      float h = vh[u], lo = vl[u];
      st.push(cnt++, h, lo);
      if (k0 + u + 1 == end) close(h, lo);
    }
  }
}

// A wider group's sum from its blocks' subtree sums (bsum[j], j < blocks,
// in consecutive warps' slots; the slots past them are its all-pad
// subtrees, +0 pairs): the top of its padded tree, adjacent pairs over its
// p2 / kBlockRows slots (2 or 4)
__device__ __forceinline__ float2 df_combine_blocks(const float2 (*bsum)[kBand], int blocks,
                                                    int width) {
  const int lane = threadIdx.x % kBand;
  float2 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < blocks ? bsum[j][lane] : make_float2(0.f, 0.f);
  df_add(v[0].x, v[0].y, v[1].x, v[1].y);
  if (width > 2 * kBlockRows) {
    df_add(v[2].x, v[2].y, v[3].x, v[3].y);
    df_add(v[0].x, v[0].y, v[2].x, v[2].y);
  }
  return v[0];
}

// The tasks of one CTA-set of a level (kReduceWarps consecutive tasks, one a
// warp), then the wider groups' combines (bsum: the warps' block sums).
template <bool kProducts, bool kMask, bool kL2>
__device__ __forceinline__ void df_reduce_set(const DfLevel& lv, int set, const double* x,
                                              long long n_x, int* ends, float2 (*levels)[kBand],
                                              double (*xs)[kGatherBatch][kBand],
                                              float2 (*bsum)[kBand]) {
  const int w = threadIdx.x / kBand;
  const int4 tk = __ldg(lv.tasks + (long long)set * kReduceWarps + w);
  if (tk.x >= 0)
    df_reduce_unit<kProducts, kMask, kL2>(lv, tk, x, n_x, ends, levels, xs, bsum[w]);
  __syncthreads();  // the blocks' sums
  if (tk.x >= 0 && tk.w > 1 && tk.z == 0) {  // block 0's warp closes the group
    const int4 ch = __ldg(lv.chunks + tk.x);
    const float2 v = df_combine_blocks(bsum + w, tk.w, ch.y - ch.x);
    lv.out[(long long)ch.z * kLane + tk.y * kBand + threadIdx.x % kBand] = v;
  }
}

// C-df's launch: its level, and the one-tile level after it that its last
// CTA closes (lv[1].n_tasks 0: none).
struct DfReduceArgs {
  DfLevel lv[2];
  const double* x;  // level 0: x in f64
  long long n_x;
  unsigned* ticket;  // lv[1]: two counters, zero between launches (the closers set them back)
};

// C-df: CTA b takes CTA-set b of lv[0]'s tasks (routed_cuda.py::
// df_reduce_tasks: a task a warp, no task split across CTAs); then, where
// lv[1] is set, the CTAs that take the last tickets (a fence, then an
// atomicAdd) wait for every CTA's sums of lv[0] and run lv[1]'s CTA-sets,
// each task's adds in the order its own launch would make them. One CTA
// running every set in turn took 26.2 us on caida_like (one H100, against
// 12.8 for level 0 alone): each set is two dependent round trips.
template <bool kProducts, bool kMask>
__global__ void __launch_bounds__(kReduceWarps * kBand, 1)
routed_df_reduce_kernel(DfReduceArgs a) {
  __shared__ int ends[kReduceWarps][kChunkGroups];  // each group's last row + 1, from the chunk's first row
  __shared__ float2 levels[kReduceWarps][kReduceLevels][kBand];  // the lanes' stack levels 1..
  __shared__ float2 bsum[kReduceWarps][kBand];  // the warps' block sums
  const int w = threadIdx.x / kBand;
  if constexpr (kProducts) {
    __shared__ double xs[kReduceWarps][2][kGatherBatch][kBand];
    df_reduce_set<true, false, false>(a.lv[0], blockIdx.x, a.x, a.n_x, ends[w], levels[w], xs[w],
                                      bsum);
    wtile::cp_async_wait<0>();  // the gathers past a task's end land before the CTA leaves
  } else {
    df_reduce_set<false, kMask, false>(a.lv[0], blockIdx.x, a.x, a.n_x, ends[w], levels[w],
                                       nullptr, bsum);
  }
  if (a.lv[1].n_tasks == 0) return;
  // the closed level's C = min(sets, CTAs) sets run at once, by the CTAs that
  // take the last C tickets (each thread's fence before the barrier makes
  // its sums visible first): each waits until every CTA has taken its
  // ticket (the others have left, or run level 0 to its end: they hold at
  // most C of the card's CTA slots, so the rest run), then runs its sets;
  // the last of them sets both counters back to 0
  __shared__ unsigned my;
  const unsigned G = gridDim.x, S = a.lv[1].n_tasks / kReduceWarps, C = S < G ? S : G;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) my = atomicAdd(a.ticket, 1u);
  __syncthreads();
  if (my < G - C) return;
  if (threadIdx.x == 0)
    while (atomicAdd(a.ticket, 0u) < G) __nanosleep(32);
  __syncthreads();
  __threadfence();
  for (unsigned set = my - (G - C); set < S; set += C) {
    __syncthreads();  // the set before has read bsum
    if (a.lv[1].mask != nullptr)
      df_reduce_set<false, true, true>(a.lv[1], set, a.x, a.n_x, ends[w], levels[w], nullptr, bsum);
    else
      df_reduce_set<false, false, true>(a.lv[1], set, a.x, a.n_x, ends[w], levels[w], nullptr,
                                        bsum);
  }
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(a.ticket + 1, 1u) == C - 1) {
    a.ticket[0] = 0u;  // every closer is past its wait
    a.ticket[1] = 0u;
  }
}

// The output gather: y[i] = (double)hi + (double)lo of the pair src[map[i]]
// (+0 where map[i] is -1) for i < n, combined into f64 as df_combine64
// does. One launch per product: map is every domain's output permutation of
// its (hi, lo) level sums composed at build time, shifted to the domain's
// region of the scratch and placed at its row bound
// (routed_cuda.py::_output_map). What bounds it is bytes: 4 of offset, 8 of
// pair and 8 of y a row (webbase_like's 1,000,005 rows: ~6.0 us at
// 3.35 TB/s). A thread owns kPermBatch = 4 adjacent rows: one 16-byte load
// of their offsets, their four 8-byte pair loads through the read-only path
// issued together, two 16-byte streaming stores of y (nothing in the
// product reads y again). The rows past a multiple of 4, and every row where
// map or y is not 16-byte aligned (vec false), take 4-byte and 8-byte
// accesses. Programmatic dependent launch (the offsets loaded before a wait
// on C-df) made a graphed product no faster on one H100 (PERF.md, row 16c),
// so it launches plainly.
__global__ void __launch_bounds__(kThreads)
routed_df_permute_kernel(const float2* __restrict__ src, const int32_t* __restrict__ map,
                         long long n, bool vec, double* __restrict__ y) {
  static_assert(kPermBatch == 4, "a thread's offsets are one int4");
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPermBatch;
  const bool whole = vec && i + kPermBatch <= n;
  int o[kPermBatch];
  if (whole) {
    const int4 m4 = __ldg(reinterpret_cast<const int4*>(map + i));
    o[0] = m4.x;
    o[1] = m4.y;
    o[2] = m4.z;
    o[3] = m4.w;
  } else {
#pragma unroll
    for (int u = 0; u < kPermBatch; ++u) o[u] = i + u < n ? __ldg(map + i + u) : -1;
  }
  float2 v[kPermBatch];
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) v[u] = o[u] >= 0 ? __ldg(src + o[u]) : make_float2(0.f, 0.f);
  double r[kPermBatch];
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) r[u] = (double)v[u].x + (double)v[u].y;
  if (whole) {
    __stcs(reinterpret_cast<double2*>(y + i), make_double2(r[0], r[1]));
    __stcs(reinterpret_cast<double2*>(y + i + 2), make_double2(r[2], r[3]));
  } else {
#pragma unroll
    for (int u = 0; u < kPermBatch; ++u)
      if (i + u < n) __stcs(y + i + u, r[u]);
  }
}

// The dense heavy rows' operands (routed_cuda.py::DFRowdotStage).
struct RowdotArgs {
  const float* hh;      // (n_h, n_pad) hi words
  const float* hl;      // lo words
  const int32_t* rows;  // (n_h,) rows of y
  double* y;
  const double* x;  // f64, split in the kernel
  long long n_x;
  long long n_pad;
  float2* part;       // the CTAs' sums, then the closers': (groups + S) * n_h * 128 pairs
  unsigned* tickets;  // S + 1 per row tile, zero between launches
  int n_h;
  int log_k;      // log2 of the columns per residue: p2 = 2^log_k * residues per row
  int tile_rows;  // rows per CTA (its tile), 1 .. kRowdotTile
  int groups;     // CTAs per row tile, a power of two
  bool x16;       // x is 16-byte aligned (x_split4's vector reads)
};

// The complete binary tree over the n pairs p[0], p[stride], ... (n a
// power of two, at most kRowdotStream), by rounds of adjacent-pair
// TwoSums, read from L2 (other CTAs of the launch wrote them), all n loads
// issued together
__device__ __forceinline__ float2 df_stream_tree(const float2* p, long long stride, int n) {
  constexpr int kB = kRowdotStream;
  float vh[kB], vl[kB];
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const float2 v = u < n ? __ldcg(p + u * stride) : make_float2(0.f, 0.f);
    vh[u] = v.x;
    vl[u] = v.y;
  }
#pragma unroll
  for (int s = 1; s < kB; s *= 2) {
#pragma unroll
    for (int i = 0; i < kB; i += 2 * s)
      if (i + s < n) df_add(vh[i], vl[i], vh[i + s], vl[i + s]);
  }
  return make_float2(vh[0], vl[0]);
}

// D-df's last steps for one row, in warp 0's layout (lane l holds the
// residues 4l .. 4l + 3 of the 128 left): lanes l and l + off, off = 16 ..
// 1, then the quad's elements (0 with 2, 1 with 3, then 0 with 1); lane 0
// writes y
__device__ __forceinline__ void df_rowdot_finish(float (&h)[kRowdotVec], float (&lo)[kRowdotVec],
                                                 double* y) {
  const int lane = threadIdx.x % 32;
  for (int off = 16; off >= 1; off /= 2) {
#pragma unroll
    for (int i = 0; i < kRowdotVec; ++i) {
      const float oh = __shfl_down_sync(0xffffffffu, h[i], off);
      const float ol = __shfl_down_sync(0xffffffffu, lo[i], off);
      if (lane < off) df_add(h[i], lo[i], oh, ol);
    }
  }
  if (lane == 0) {
    df_add(h[0], lo[0], h[2], lo[2]);
    df_add(h[1], lo[1], h[3], lo[3]);
    df_add(h[0], lo[0], h[1], lo[1]);
    *y = (double)h[0] + (double)lo[0];
  }
}

// One closing step of D-df for the CTA's nr rows: each (row, residue)'s n
// pairs src[rr * 128 + e + u * stride], u = 0 .. n - 1 (e = i * 32 + lane
// for residue 4 * lane + i), summed by df_stream_tree, a warp per (row, i);
// into dst at the same (row, e) where dst is set, else the rows are
// finished (df_rowdot_finish) into y
__device__ __forceinline__ void df_rowdot_close(const float2* src, long long stride, int n,
                                                float2* dst, int nr, const RowdotArgs& a,
                                                int r_lo, float2* cl) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int t = w; t < nr * kRowdotVec; t += nw) {
    const int e = t * 32 + lane;  // (row t / 4, i = t % 4, lane)
    const float2 v = df_stream_tree(src + e, stride, n);
    if (dst != nullptr)
      dst[e] = v;
    else
      cl[e] = v;
  }
  if (dst != nullptr) return;
  __syncthreads();
  for (int rr = w; rr < nr; rr += nw) {
    float rh[kRowdotVec], rl[kRowdotVec];
#pragma unroll
    for (int i = 0; i < kRowdotVec; ++i) {
      const float2 v = cl[(rr * kRowdotVec + i) * 32 + lane];
      rh[i] = v.x;
      rl[i] = v.y;
    }
    df_rowdot_finish(rh, rl, a.y + __ldg(a.rows + r_lo + rr));
  }
}

// D-df: y[rows[r]] = (double)hi + (double)lo of heavy row r's df dot with
// x, one launch: the products (a TwoProduct and the cross terms) of the
// columns padded with +0 pairs to p2 = 2^log_k * P, summed by the halving
// tree (column c with c + p2/2, ..., routed_cuda.py::df_dense_rowdot, the
// JAX package's _df_dense_rowdot). Residue p < P = 4 * blockDim.x * groups
// owns the columns p + P*k. CTA g of tile t takes the tile's rows (up to
// kRowdotTile, routed_cuda.py::rowdot_plan picks them from the block's
// shape) one after the other, and for each the residues whose bits are,
// from the lowest: a quad's element i (2 bits: one float4 of each array per
// column step), the lane (a warp reads 512 contiguous bytes of each
// array), g, the warp. Where a residue has at most 4 columns (the plan's
// aim) x at the thread's columns is read in f64 and split (x_split4) once
// for all the tile's rows and kept in registers; else once per row, from
// L1 after the first. The halving tree takes the bits of the column from
// the top: a residue's columns first (they stream in bit-reversed k order,
// an aligned block of 4 at a time: a static subtree, then one push into a
// DfStack whose levels sit in a local array), then the warps (each row's
// sums wait in shared memory until the tile's last row is done: the rows
// run without a barrier), in each CTA, which leaves its 128 pairs per row
// in part; then
// g's bits, g = s + S*m (M = min(G, 16) values of m): the last CTA of the
// M that share s (a fence, then an atomicAdd on a self-resetting ticket)
// streams each (row, residue)'s M pairs (stored in bit-reversed m order, a
// plane apart, so that a warp's loads are coalesced: the halving over m);
// where S > 1 it leaves the sums at s's bit-reversed plane and the last of
// the S such CTAs streams those (the halving over s); the last closer
// then adds the lanes and the quad's elements (df_rowdot_finish). Each
// pairing is fixed, so a rerun is bitwise equal. Padded columns go through
// the same TwoSums as +0 pairs. Bound: the block's bytes, x once and y.
__global__ void __launch_bounds__(kRowdotCta, 2) routed_df_rowdot_kernel(RowdotArgs a) {
  constexpr int V = kRowdotVec, B = kRowdotBlock;
  __shared__ float4 red_h[kRowdotTile][kRowdotCta], red_l[kRowdotTile][kRowdotCta];
  __shared__ bool last;
  const int nt = blockDim.x, tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int G = a.groups, g = blockIdx.x;
  const int r_lo = blockIdx.y * a.tile_rows, r_hi = min(r_lo + a.tile_rows, a.n_h);
  const long long P = (long long)nt * V * G;
  const long long c_t = (long long)V * (lane + 32 * (g + (long long)G * w));
  const int K = 1 << a.log_k;
  const int M = G < kRowdotStream ? G : kRowdotStream, S = G / M, s = g % S;
  const int log_m = 31 - __clz(M), log_s = 31 - __clz(S);
  const int jm = log_m ? (int)(__brev((unsigned)(g / S)) >> (32 - log_m)) : 0;
  const long long plane = (long long)a.n_h * 128;  // pairs of one plane of part
  unsigned* tk = a.tickets + (long long)blockIdx.y * (S + 1);  // S groups', the tile's
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // columns c_t + P*rev(j0 + u) (rev over log_k bits) .. + 3; a block past K
  // or columns past n_pad give +0 pairs (+0 values times +0 x)
  long long col[B];
  bool in[B];
  float xh[B][V], xl[B][V];
  auto load_x = [&](int j0) {
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int j = j0 + u;
      const unsigned k = a.log_k ? __brev((unsigned)j) >> (32 - a.log_k) : 0u;
      col[u] = c_t + P * k;
      in[u] = j < K && col[u] < a.n_pad;
      if (in[u]) {
        x_split4(a.x, col[u], a.n_x, a.x16, xh[u], xl[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xh[u][i] = xl[u][i] = 0.f;
      }
    }
  };
  if (K <= B) load_x(0);
  for (int row = r_lo; row < r_hi; ++row) {
    float h[V], lo[V];
    float2 levels[V][kRowdotLevels];
    DfStack<1> st[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      st[i].mem = levels[i];
      h[i] = lo[i] = 0.f;
    }
    const float* hh = a.hh + (long long)row * a.n_pad;
    const float* hl = a.hl + (long long)row * a.n_pad;
    for (int j0 = 0; j0 < K; j0 += B) {
      if (K > B) load_x(j0);
      float4 vh[B], vl[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        vh[u] = in[u] ? __ldcg(reinterpret_cast<const float4*>(hh + col[u])) : zero;
        vl[u] = in[u] ? __ldcg(reinterpret_cast<const float4*>(hl + col[u])) : zero;
      }
      float ph[V][B], pl[V][B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        df_prod(vh[u].x, vl[u].x, xh[u][0], xl[u][0], ph[0][u], pl[0][u]);
        df_prod(vh[u].y, vl[u].y, xh[u][1], xl[u][1], ph[1][u], pl[1][u]);
        df_prod(vh[u].z, vl[u].z, xh[u][2], xl[u][2], ph[2][u], pl[2][u]);
        df_prod(vh[u].w, vl[u].w, xh[u][3], xl[u][3], ph[3][u], pl[3][u]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (K >= B) {  // an aligned block of j: its subtree, one push
          df_tree<B>(ph[i], pl[i]);
          h[i] = ph[i][0];
          lo[i] = pl[i][0];
          if (K > B) st[i].push_block(j0, kRowdotBlockLog, h[i], lo[i]);
        } else {  // the residue's K < B columns: their tree
#pragma unroll
          for (int s2 = 1; s2 < B; s2 *= 2) {
#pragma unroll
            for (int u = 0; u < B; u += 2 * s2)
              if (s2 < K) df_add(ph[i][u], pl[i][u], ph[i][u + s2], pl[i][u + s2]);
          }
          h[i] = ph[i][0];
          lo[i] = pl[i][0];
        }
      }
    }
    // (h[i], lo[i]): residue c_t + i's columns of this row summed, kept
    // in shared memory: the warps go on to the next row without a barrier
    red_h[row - r_lo][tid] = make_float4(h[0], h[1], h[2], h[3]);
    red_l[row - r_lo][tid] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  // each row's warps w and w + half pair, half = nt/64 .. 1
  const int nr = r_hi - r_lo;
  for (int half = nt / 64; half >= 1; half /= 2) {
    __syncthreads();
    if (w < half) {
      for (int rr = 0; rr < nr; ++rr) {
        float4 vh = red_h[rr][tid], vl = red_l[rr][tid];
        const float4 oh = red_h[rr][tid + 32 * half], ol = red_l[rr][tid + 32 * half];
        df_add(vh.x, vl.x, oh.x, ol.x);
        df_add(vh.y, vl.y, oh.y, ol.y);
        df_add(vh.z, vl.z, oh.z, ol.z);
        df_add(vh.w, vl.w, oh.w, ol.w);
        red_h[rr][tid] = vh;
        red_l[rr][tid] = vl;
      }
    }
  }
  // the CTA's 128 pairs of each row: residue 4*lane + i's at (row, i * 32
  // + lane) of plane jm * S + s
  if (w == 0) {
    for (int rr = 0; rr < nr; ++rr) {
      const float4 vh = red_h[rr][lane], vl = red_l[rr][lane];
      float2* out = a.part + (jm * S + s) * plane + (long long)(r_lo + rr) * 128 + lane;
      out[0] = make_float2(vh.x, vl.x);
      out[32] = make_float2(vh.y, vl.y);
      out[64] = make_float2(vh.z, vl.z);
      out[96] = make_float2(vh.w, vl.w);
    }
  }
  // the CTA that takes the last ticket of the M sharing s has their pairs
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tk + s, 1u) == (unsigned)M - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float2* cl = reinterpret_cast<float2*>(&red_h[0][0]);  // free now: the finishing rows' pairs
  const long long r0 = (long long)r_lo * 128;
  float2* part2 = a.part + G * plane;  // the S closers' sums, plane rev(s)
  if (S == 1) {
    df_rowdot_close(a.part + r0, plane, M, nullptr, nr, a, r_lo, cl);
    if (tid == 0) tk[0] = 0u;
    return;
  }
  const int js = (int)(__brev((unsigned)s) >> (32 - log_s));
  df_rowdot_close(a.part + s * plane + r0, S * plane, M, part2 + js * plane + r0, nr, a, r_lo,
                  cl);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tk[s] = 0u;
    last = atomicAdd(tk + S, 1u) == (unsigned)S - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  df_rowdot_close(part2 + r0, plane, S, nullptr, nr, a, r_lo, cl);
  if (tid == 0) tk[S] = 0u;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// ---- the routed df program (routed_df_chain_launch) -----------------------

// C-df: a CTA per CTA-set of kReduceWarps tasks of lv[0] (products: level
// 0, the slots' values and x columns); lv[1], where set, is closed by the
// CTAs that take the last tickets (ticket: zero). Its sets are at most
// kMaxCloseSets: the closers that wait at once hold no more CTA slots than
// that, far fewer than the card has (an SM holds one CTA at least), so the
// CTAs they wait for run; a larger level is refused, not run.
int df_reduce_launch(const DfReduceArgs& a, bool products, cudaStream_t st) {
  const int sets = a.lv[0].n_tasks / kReduceWarps;
  if (sets < 1 || a.lv[0].n_tasks % kReduceWarps || a.lv[1].n_tasks % kReduceWarps ||
      a.lv[1].n_tasks < 0 || a.lv[1].n_tasks > kMaxCloseSets * kReduceWarps ||
      (a.lv[1].n_tasks > 0 && a.ticket == nullptr) ||
      (products && (a.lv[0].vals == nullptr || a.x == nullptr)) ||
      (!products && a.lv[0].src == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = kReduceWarps * kBand;
  const bool mask = a.lv[0].mask != nullptr;
  if (products && mask) return (int)cudaErrorInvalidValue;  // level 0 has no mask
  if (products)
    routed_df_reduce_kernel<true, false><<<sets, threads, 0, st>>>(a);
  else if (mask)
    routed_df_reduce_kernel<false, true><<<sets, threads, 0, st>>>(a);
  else
    routed_df_reduce_kernel<false, false><<<sets, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int df_permute_launch(const float2* src, const int32_t* map, long long n, double* y,
                      cudaStream_t st) {
  const long long per_cta = (long long)kThreads * kPermBatch;
  const bool vec = (((uintptr_t)map | (uintptr_t)y) & 15) == 0;
  routed_df_permute_kernel<<<(unsigned)((n + per_cta - 1) / per_cta), kThreads, 0, st>>>(
      src, map, n, vec, y);
  return (int)cudaGetLastError();
}

// D-df (routed_cuda.py::rowdot_plan): groups CTAs (a power of two up to
// kMaxRowdotGroups) per tile of tile_rows rows (1 .. kRowdotTile), cta
// threads a CTA (a power of two from 32 to kRowdotCta), cta * groups * 4 *
// 2^log_k the power of two of n_pad; part holds (groups + S) * n_h * 128
// pairs of scratch and tickets S + 1 zero words per tile (S = groups / 16,
// at least 1)
int df_rowdot_launch(const RowdotArgs& a, int cta, cudaStream_t st) {
  const long long cols = (long long)cta * a.groups * kRowdotVec << a.log_k;
  auto pow2 = [](int v, int top) { return v >= 1 && v <= top && !(v & (v - 1)); };
  if (!pow2(a.groups, kMaxRowdotGroups) || !pow2(cta, kRowdotCta) || cta < 32 ||
      a.tile_rows < 1 || a.tile_rows > kRowdotTile || a.log_k < 0 || a.log_k > kRowdotLevels ||
      a.n_h < 1 || cols < a.n_pad || cols >= 2 * a.n_pad ||  // cols: the power of two of n_pad
      a.n_pad % kRowdotVec || a.x == nullptr || a.part == nullptr || a.tickets == nullptr ||
      ((uintptr_t)a.part & 7) || (((uintptr_t)a.hh | (uintptr_t)a.hl) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.groups, (unsigned)((a.n_h + a.tile_rows - 1) / a.tile_rows));
  routed_df_rowdot_kernel<<<grid, cta, 0, st>>>(a);
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

enum DfOp { kOpDfReduce = 1, kOpDfGatherReduce = 2, kOpDfPermute = 3, kOpDfRowdot = 4 };
constexpr int kDfOpWords[] = {0, 9, 17, 5, 13};  // by op: the op and its operands

// a C-df level (null vals or src: the other kind of level)
DfLevel df_level(const float2* vals, const int32_t* idx, const float2* src, const float* mask,
                 const int32_t* groups, const int32_t* chunks, const int32_t* tasks,
                 long long n_tasks, float2* out) {
  DfLevel lv;
  lv.vals = vals;
  lv.idx = idx;
  lv.src = src;
  lv.mask = mask;
  lv.groups = reinterpret_cast<const int2*>(groups);
  lv.chunks = reinterpret_cast<const int4*>(chunks);
  lv.tasks = reinterpret_cast<const int4*>(tasks);
  lv.n_tasks = (int)n_tasks;
  lv.out = out;
  return lv;
}

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
// routed_cuda.py::_df_op) on the stream: C-df per level (level 0 forming
// K3's products from x, f64, length n_x, and closing the one-tile level
// after it where the program says so), the output gather and D-df (the
// dense heavy rows, x split in it); y is f64. counts[0..3] (host memory)
// gains one for each op of these four kinds that was enqueued without
// error. Returns the first error, or 0; nothing after it is enqueued.
int routed_df_chain_launch(const long long* prog, int len, const double* x, long long n_x,
                           double* y, void* scratch, int* counts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto P = [&](int i) { return resolve(prog[i], (char*)scratch, (char*)y); };
  int i = 0;
  while (i < len) {
    const long long op = prog[i];
    if (op < kOpDfReduce || op > kOpDfRowdot || i + kDfOpWords[op] > len)
      return (int)cudaErrorInvalidValue;
    int rc;
    switch ((int)op) {
      case kOpDfReduce: {  // src off mask groups chunks tasks n_tasks out
        DfReduceArgs a = {};
        a.lv[0] = df_level(nullptr, (const int32_t*)P(i + 2), (const float2*)P(i + 1),
                           (const float*)P(i + 3), (const int32_t*)P(i + 4),
                           (const int32_t*)P(i + 5), (const int32_t*)P(i + 6), prog[i + 7],
                           (float2*)P(i + 8));
        rc = df_reduce_launch(a, false, st);
        break;
      }
      case kOpDfGatherReduce: {  // vals cols groups chunks tasks n_tasks out, then the
                                 // closed level's src off mask groups chunks tasks
                                 // n_tasks out (n_tasks 0: none), ticket
        DfReduceArgs a = {};
        a.lv[0] = df_level((const float2*)P(i + 1), (const int32_t*)P(i + 2), nullptr, nullptr,
                           (const int32_t*)P(i + 3), (const int32_t*)P(i + 4),
                           (const int32_t*)P(i + 5), prog[i + 6], (float2*)P(i + 7));
        a.lv[1] = df_level(nullptr, (const int32_t*)P(i + 9), (const float2*)P(i + 8),
                           (const float*)P(i + 10), (const int32_t*)P(i + 11),
                           (const int32_t*)P(i + 12), (const int32_t*)P(i + 13), prog[i + 14],
                           (float2*)P(i + 15));
        a.ticket = (unsigned*)P(i + 16);
        a.x = x;
        a.n_x = n_x;
        rc = df_reduce_launch(a, true, st);
        break;
      }
      case kOpDfPermute:  // src map n y
        rc = df_permute_launch((const float2*)P(i + 1), (const int32_t*)P(i + 2), prog[i + 3],
                               (double*)P(i + 4), st);
        break;
      case kOpDfRowdot: {  // hh hl rows y n_h n_pad log_k cta groups tile_rows part tickets
        RowdotArgs a = {};
        a.hh = (const float*)P(i + 1);
        a.hl = (const float*)P(i + 2);
        a.rows = (const int32_t*)P(i + 3);
        a.y = (double*)P(i + 4);
        a.n_h = (int)prog[i + 5];
        a.n_pad = prog[i + 6];
        a.log_k = (int)prog[i + 7];
        a.groups = (int)prog[i + 9];
        a.tile_rows = (int)prog[i + 10];
        a.part = (float2*)P(i + 11);
        a.tickets = (unsigned*)P(i + 12);
        a.x = x;
        a.n_x = n_x;
        a.x16 = ((uintptr_t)x & 15) == 0;
        rc = df_rowdot_launch(a, (int)prog[i + 8], st);
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
