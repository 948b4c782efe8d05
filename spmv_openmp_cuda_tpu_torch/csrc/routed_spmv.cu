// Clos-routed SpMV kernels for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernels of spmv_openmp_cuda_tpu/formats/routed.py and
// spmv_openmp_cuda_tpu/ops/route.py:
//   routed_gather_kernel       (A) <- _gather_w1 (pallas_call at :959, :1005)
//                                     and, with W1 off, _gather_products (:910)
//   routed_w_stage_kernel      (B) <- ops/route.py::_whole_w_call (:347) and
//                                     _tiled_call (:298), with the SW grid
//                                     transposes around W2 (:363, :368) folded
//                                     into its row addressing
//   routed_perm_reduce_kernel  (C) <- _w3_r3_reduce (:1239), _perm_reduce_t1
//                                     (:1274), _reduce_runs_fused (:1310)
//   routed_hdense_kernel       (D) <- _hdense_mv (:1060)
//   routed_heavy_kernel        (E) <- _heavy_sums (:1134), the pooled heavy
//                                     tiles
//   routed_small_kernel            <- _routed_small_spmv (:1440): A, B, C
//                                     and the output permutation of a small
//                                     domain in one launch
//   routed_row_sums_kernel         closes D and E: per heavy row, its
//                                     partial sums added in a fixed order
//
// Layout: every slab is (rows, 128) f32, row-major; index arrays are (rows,
// 128) int8 with values in [0, 128). A W stage permutes, for each lane, the
// rows inside one 128-row tile: out[T*128 + j, l] = in[T*128 + w[T*128 + l,
// j], l]. An R stage permutes the lanes of each row: out[p, l] = in[p, r[p,
// l]]. SW maps row s*t + tt of its output to row tt*128 + s of its input.
//
// What bounds them: bytes. Every stage is data movement or one multiply-add
// per element; the chain on caida_like moves ~38 MB per product. So each
// kernel is built to read and write whole 128-byte rows:
//   - A and B take one CTA per (128-row tile, band of 32 lanes): four times
//     the CTAs of one per tile (caida's 64-tile products domain gives 256),
//     with no exchange between CTAs, because a W stage never mixes lanes.
//     The band's 128 x 32 inputs (products for A) and its 32 index rows are
//     staged in shared memory with row-contiguous loads; the output tile is
//     then written row by row. B with an R stage after it (r_after) needs
//     whole rows and takes one CTA per tile (80 KB of shared memory).
//   - C takes one CTA per output group (128 lanes): thread l sums lane l of
//     the group's `width` slab rows, each read through the W3/R3 (or r1, wc,
//     r3) indices straight from global memory (the 64 KB tile stays in L1).
//     Wide groups (width 128) take 128 times the work of narrow ones; they
//     come first in the group order, so they start first.
//   - D splits each heavy row over CTAs of 4096 columns: 16-byte loads of
//     bf16 H, per-thread sums of 16 products, a shuffle tree per CTA, whose
//     sum goes to a scratch slot of its own; routed_row_sums_kernel then
//     adds a row's slots in CTA order into the row's (zeroed) sum.
//   - E takes one CTA per pooled tile (T*128 + a, l): its 128 x 128
//     products, x gathered by global column, are staged in shared memory;
//     the residues' runs (lanes (hlo, hhi] of row slot j) are summed each by
//     one thread, four threads per residue over disjoint slot quarters, the
//     sum left in the run's last lane; then each slot's runs are added over
//     the residues in order. The slot sums go to scratch, and
//     routed_row_sums_kernel adds each heavy row's slots (in slot order)
//     into y. The TPU's cumsum by triangular matmul and its differences are
//     a device of the MXU; the sums here are direct. Bound: bytes (hvals,
//     hpidx, hlo, hhi and x, ~27 MB per product on webbase_like).
//   - The small kernel composes the chain. Its permutations are static, so
//     build_chain runs element ids through them (the plain W stages) and
//     folds in C's groups: each row i of y gets the gather slots whose
//     products C adds into it, in C's order, as a per-row slot list
//     (row_slots[row_ptr[i] .. row_ptr[i+1]), at most h1*128 int32). The
//     kSmallLanes threads of a row then load a round of 16 of its slots
//     (each thread four), the slots' values and panels, then x: three
//     dependent round trips after row_ptr, no slab in between, no barrier,
//     CTAs of 64 threads so that the rows spread over many SMs. The
//     products pass by shuffle, and each of the row's threads adds them one
//     at a time in list order. Products and adds are __fmul_rn/__fadd_rn
//     (never contracted into an FMA), as A multiplies and C adds, so y
//     equals the staged chain's bit for bit. Bound: latency, the scattered
//     loads of the slots' operands and of x (delaunay's ~0.6 MB stay in
//     L2): four threads per row keep four times the loads in flight that
//     one thread would. (Stages run one after another in one CTA, as the
//     TPU kernel runs them in VMEM, are bound by that one SM's issue rate.)
// Nothing closes with atomics: every sum is taken in an order fixed by the
// layout, so a rerun is bitwise equal. x is read by global column behind a
// bounds test against n (no padded window stack is built). Products and
// data movement are exact, so A and B equal their plain versions bit for
// bit; C, D and E sum in another order.
//
// routed_chain_launch is the one entry point: it enqueues a program of these
// launches and memsets (a whole product, built once per prepared matrix, or
// one stage for the kernel checks) in one call, and counts the launches it
// made, so the launch counters are those of the run and not of the plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kBand = 32;             // lanes per CTA of A and of B without r_after
constexpr int kPitch = kLane + 4;     // bytes per staged index row (+4: spreads banks)
constexpr int kThreads = 256;
constexpr long long kWindowElems = 128LL * 128;
constexpr int kHChunk = kThreads * 8 * 2;  // columns of H per CTA of D
constexpr int kHeavyThreads = 512;         // E: 4 threads per residue
constexpr int kPPitch = kLane + 1;         // floats per staged product row of E
constexpr int kSmallLanes = 4;             // threads per row of y of the small kernel
constexpr int kSmallBatch = 4;             // list slots whose loads such a thread issues together
constexpr int kSmallThreads = 64;          // threads per CTA of the small kernel
constexpr int kRowWarps = 8;               // heavy rows per CTA of the row sums

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage kRows rows of a (., 128) int8 index array, row-contiguous 4-byte
// loads, into shared rows of pitch kPitch, by kT threads: all of a thread's
// loads are issued before its first store.
template <int kRows, int kT>
__device__ __forceinline__ void stage_index_rows(const int8_t* __restrict__ src,
                                                 unsigned char* dst) {
  constexpr int kWords = kRows * (kLane / 4), kW = kWords / kT;
  static_assert(kWords % kT == 0, "whole rounds of the CTA's threads");
  uint32_t v[kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    const int c = threadIdx.x + u * kT;
    v[u] = reinterpret_cast<const uint32_t*>(src + (long long)(c / (kLane / 4)) * kLane)
        [c % (kLane / 4)];
  }
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    const int c = threadIdx.x + u * kT;
    reinterpret_cast<uint32_t*>(dst + (c / (kLane / 4)) * kPitch)[c % (kLane / 4)] = v[u];
  }
}

// A: out tile i, lane l = band*32 + lb, row j:
//   s = w1 ? w1[i*128 + l, j] : j
//   out[i*128 + j, l] = vals[i*128 + s, l] * x[widx[i]*16384 + pidx[i*128 + s, l]*128 + s]
// and zeros for the pad tiles i >= n_real.
template <typename T>
__global__ void __launch_bounds__(kThreads)
routed_gather_kernel(const T* __restrict__ vals, const int8_t* __restrict__ pidx,
                     const int32_t* __restrict__ widx, const int8_t* __restrict__ w1,
                     int n_real, const float* __restrict__ x, long long n_x,
                     float* __restrict__ out) {
  __shared__ float prod[kLane * kBand];
  __shared__ __align__(16) unsigned char ws[kBand * kPitch];
  const int tile = blockIdx.x / (kLane / kBand);
  const int band = blockIdx.x % (kLane / kBand);
  const int lb = threadIdx.x % kBand, r0 = threadIdx.x / kBand;
  constexpr int kRowStep = kThreads / kBand;
  const int l = band * kBand + lb;
  const long long base = (long long)tile * kLane * kLane;
  float* o = out + base + l;
  if (tile >= n_real) {
    for (int j = r0; j < kLane; j += kRowStep) o[(long long)j * kLane] = 0.f;
    return;
  }
  const long long xw = (long long)widx[tile] * kWindowElems;
#pragma unroll
  for (int k = 0; k < kLane / kRowStep; ++k) {
    const int s = r0 + k * kRowStep;
    const long long e = base + (long long)s * kLane + l;
    const long long col = xw + (long long)pidx[e] * kLane + s;
    const float xv = (col >= 0 && col < n_x) ? __ldg(x + col) : 0.f;
    prod[s * kBand + lb] = to_f32(vals[e]) * xv;
  }
  if (w1 != nullptr)
    stage_index_rows<kBand, kThreads>(w1 + base + (long long)band * kBand * kLane, ws);
  __syncthreads();
  for (int j = r0; j < kLane; j += kRowStep) {
    const int s = w1 != nullptr ? (int)reinterpret_cast<const int8_t*>(ws)[lb * kPitch + j] : j;
    o[(long long)j * kLane] = prod[s * kBand + lb];
  }
}

// B: for output tile Q of the W stage (rows q = Q*128 + j):
//   A1[p, l] = p < in_rows ? in[p, r ? r[p, l] : l] : 0
//   A2[q]    = A1[sw ? (q % t)*128 + q / t : q]
//   A3[q, l] = A2[Q*128 + w[Q*128 + l, j], l]
//   A4[p]    = A3[q] at p = sw ? (q % t)*128 + q / t : q
//   out[p, l] = A4[p, ra ? ra[p, l] : l], written where p*128 + l < out_limit
// kWhole: one CTA per tile (needed for ra); else one per (tile, lane band).
// Each thread takes kN elements, kB at a time whose loads are all issued
// before any of them is used (a loop that waits on each load in turn runs
// at one load latency per element).
template <bool kWhole>
__global__ void __launch_bounds__(kThreads)
routed_w_stage_kernel(const float* __restrict__ in, int in_rows, const int8_t* __restrict__ r,
                      const int8_t* __restrict__ w, const int8_t* __restrict__ ra, int t,
                      int sw, float* __restrict__ out, long long out_limit) {
  constexpr int L = kWhole ? kLane : kBand;
  constexpr int kBands = kLane / L;
  constexpr int kN = kLane * L / kThreads;
  constexpr int kB = kN < 16 ? kN : 16;
  static_assert(kLane * L % kThreads == 0 && kN % kB == 0, "whole batches of the CTA");
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);       // [128][L]
  unsigned char* ws = smem + kLane * L * sizeof(float);  // [L][kPitch]
  const int tq = blockIdx.x / kBands;
  const int lane0 = (blockIdx.x % kBands) * L;
#pragma unroll 1
  for (int k0 = 0; k0 < kN; k0 += kB) {
    float v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = threadIdx.x + (k0 + u) * kThreads;
      const int q = tq * kLane + c / L;
      const int p = sw ? (q % t) * kLane + q / t : q;
      v[u] = 0.f;
      if (p < in_rows) {
        const int l = lane0 + c % L;
        const int src_l = r != nullptr ? (int)r[(long long)p * kLane + l] : l;
        v[u] = in[(long long)p * kLane + src_l];
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) stage[threadIdx.x + (k0 + u) * kThreads] = v[u];  // [c/L][c%L]
  }
  stage_index_rows<L, kThreads>(w + ((long long)tq * kLane + lane0) * kLane, ws);
  __syncthreads();
#pragma unroll 1
  for (int k0 = 0; k0 < kN; k0 += kB) {
    int m[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = threadIdx.x + (k0 + u) * kThreads;
      const int q = tq * kLane + c / L;
      const int p = sw ? (q % t) * kLane + q / t : q;
      m[u] = (kWhole && ra != nullptr) ? (int)ra[(long long)p * kLane + lane0 + c % L] : c % L;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = threadIdx.x + (k0 + u) * kThreads;
      const int j = c / L;
      const int q = tq * kLane + j;
      const int p = sw ? (q % t) * kLane + q / t : q;
      const long long o = (long long)p * kLane + lane0 + c % L;
      const int src = (int)reinterpret_cast<const int8_t*>(ws)[m[u] * kPitch + j];
      if (o < out_limit) out[o] = stage[src * L + m[u]];
    }
  }
}

// C: out[gi, l] = sum_{k < width_gi} g[row0_gi + k, l] with
//   g[rr, l] = (mask ? mask[rr, l] : 1) * S(rr, r3[rr, l]) and
//   mode 0: S(rr, m) = src[rr, m]
//   mode 1: S(rr, m) = src[T*128 + W[T*128 + m, rr % 128], m], T = rr / 128  (W3)
//   mode 2: S(rr, m) = src[p, r1[p, m]], p = W[m, rr]          (t = 1: r1 . wc)
// where src rows >= src_rows read as zero.
__global__ void __launch_bounds__(kLane)
routed_perm_reduce_kernel(const float* __restrict__ src, int src_rows, int mode,
                          const int8_t* __restrict__ W, const int8_t* __restrict__ r1,
                          const int8_t* __restrict__ r3, const float* __restrict__ mask,
                          const int2* __restrict__ groups, float* __restrict__ out) {
  const int gi = blockIdx.x;
  const int l = threadIdx.x;
  const int2 g = groups[gi];  // (row0, width)
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < g.y; ++k) {
    const int rr = g.x + k;
    const long long e = (long long)rr * kLane + l;
    const int m = r3[e];
    int p, c;
    if (mode == 1) {
      const int tb = rr & ~(kLane - 1);
      p = tb + W[(long long)(tb + m) * kLane + (rr & (kLane - 1))];
      c = m;
    } else if (mode == 2) {
      p = W[m * kLane + rr];
      c = r1[p * kLane + m];
    } else {
      p = rr;
      c = m;
    }
    float v = p < src_rows ? __ldg(src + (long long)p * kLane + c) : 0.f;
    if (mask != nullptr) v *= mask[e];
    acc += v;
  }
  out[(long long)gi * kLane + l] = acc;
}

// D: part[k*gridDim.x + blockIdx.x] = sum over this CTA's columns c of
// f32(H[k, c]) * x[c] (x is zero past n_x; n_pad is a multiple of 128).
__global__ void __launch_bounds__(kThreads)
routed_hdense_kernel(const __nv_bfloat16* __restrict__ H, long long n_pad,
                     const float* __restrict__ x, long long n_x, float* __restrict__ part) {
  const int k = blockIdx.y;
  const __nv_bfloat16* h = H + (long long)k * n_pad;
  float acc = 0.f;
#pragma unroll
  for (int it = 0; it < kHChunk / (kThreads * 8); ++it) {
    const long long c = (long long)blockIdx.x * kHChunk + ((long long)it * kThreads + threadIdx.x) * 8;
    if (c < n_pad) {
      const uint4 hv = *reinterpret_cast<const uint4*>(h + c);
      const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&hv);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float xv = c + u < n_x ? __ldg(x + c + u) : 0.f;
        acc += __bfloat162float(hb[u]) * xv;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) part[(long long)k * gridDim.x + blockIdx.x] = v;
  }
}

// D's and E's close, one warp per heavy row k: out[dst[k]] += the sum of
// part at the row's entries [b, e) (ptr[k], ptr[k + 1], or k*seg, (k+1)*seg
// without ptr), through idx where given, lane by lane and then by a fixed
// shuffle tree.
__global__ void __launch_bounds__(kRowWarps * 32)
routed_row_sums_kernel(const float* __restrict__ part, const int32_t* __restrict__ ptr,
                       const int32_t* __restrict__ idx, int seg,
                       const int32_t* __restrict__ dst, int n_rows, float* __restrict__ out) {
  const int k = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (k >= n_rows) return;  // a whole warp
  const long long b = ptr != nullptr ? ptr[k] : (long long)k * seg;
  const long long e = ptr != nullptr ? ptr[k + 1] : (long long)(k + 1) * seg;
  float acc = 0.f;
  for (long long i = b + lane; i < e; i += 32) acc += part[idx != nullptr ? idx[i] : i];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[dst[k]] += acc;
}

// E: tile T's slot sums part[T*128 + j] = sum over residues a, in order, of
// the lanes (hlo, hhi] of row T*128 + a in slot j, each lane l holding
// hvals[T*128 + a, l] * x[hwidx[T]*16384 + hpidx[T*128 + a, l]*128 + a]
// (-1: no term; the runs of one residue are disjoint and nonempty).
template <typename T>
__global__ void __launch_bounds__(kHeavyThreads, 2)
routed_heavy_kernel(const T* __restrict__ hvals, const int8_t* __restrict__ hpidx,
                    const int32_t* __restrict__ hwidx, const int8_t* __restrict__ hlo,
                    const int8_t* __restrict__ hhi, const float* __restrict__ x, long long n_x,
                    float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);                          // [128][kPPitch]
  unsigned char* lo_s = smem + kLane * kPPitch * sizeof(float);       // [128][kPitch]
  unsigned char* hi_s = lo_s + kLane * kPitch;                        // [128][kPitch]
  float* red = reinterpret_cast<float*>(hi_s + kLane * kPitch);       // [4][128]
  constexpr int kQuarters = kHeavyThreads / kLane;
  const int tile = blockIdx.x;
  const long long base = (long long)tile * kLane * kLane;
  const long long xw = (long long)hwidx[tile] * kWindowElems;
  {
    const int l = threadIdx.x % kLane;
#pragma unroll 8
    for (int a = threadIdx.x / kLane; a < kLane; a += kQuarters) {
      const long long e = base + (long long)a * kLane + l;
      const long long col = xw + (long long)hpidx[e] * kLane + a;
      const float xv = (col >= 0 && col < n_x) ? __ldg(x + col) : 0.f;
      P[a * kPPitch + l] = to_f32(hvals[e]) * xv;
    }
  }
  stage_index_rows<kLane, kHeavyThreads>(hlo + base, lo_s);
  stage_index_rows<kLane, kHeavyThreads>(hhi + base, hi_s);
  __syncthreads();
  const int lane = threadIdx.x % kLane, quarter = threadIdx.x / kLane;
  {  // residue `lane`, slots of this quarter: each run's sum into its last lane
    float* pa = P + lane * kPPitch;
    const signed char* lo_a = reinterpret_cast<const signed char*>(lo_s) + lane * kPitch;
    const signed char* hi_a = reinterpret_cast<const signed char*>(hi_s) + lane * kPitch;
    for (int j = quarter * (kLane / kQuarters); j < (quarter + 1) * (kLane / kQuarters); ++j) {
      const int hi = hi_a[j];
      if (hi < 0) continue;
      float acc = 0.f;
      for (int c = lo_a[j] + 1; c <= hi; ++c) acc += pa[c];
      pa[hi] = acc;
    }
  }
  __syncthreads();
  {  // slot `lane`, residues of this quarter in order
    const signed char* hi_j = reinterpret_cast<const signed char*>(hi_s) + lane;
    float acc = 0.f;
    for (int a = quarter * (kLane / kQuarters); a < (quarter + 1) * (kLane / kQuarters); ++a) {
      const int hi = hi_j[a * kPitch];
      if (hi >= 0) acc += P[a * kPPitch + hi];
    }
    red[quarter * kLane + lane] = acc;
  }
  __syncthreads();
  if (threadIdx.x < kLane) {
    float acc = red[threadIdx.x];
    for (int q = 1; q < kQuarters; ++q) acc += red[q * kLane + threadIdx.x];
    part[(long long)tile * kLane + threadIdx.x] = acc;
  }
}

size_t heavy_smem() {
  return (size_t)kLane * kPPitch * sizeof(float) + 2 * (size_t)kLane * kPitch +
         (size_t)(kHeavyThreads / kLane) * kLane * sizeof(float);
}

// The small kernel's operands (routed_cuda.py::SmallStage): the gather
// tiles and the per-row slot lists, row i of y summing the products of the
// gather slots row_slots[row_ptr[i] .. row_ptr[i+1]) in that order.
struct SmallArgs {
  const void* vals;
  const int8_t* pidx;
  const int32_t* widx;
  const int32_t* row_ptr;
  const int32_t* row_slots;
  float* y;
  long long m;
};

// The small kernel, kSmallLanes threads per row i of y: the products of its
// list's gather slots (A's arithmetic: vals * x at the slot's column, x zero
// past n_x), added one at a time from +0 in list order (C's order). Per
// round of kSmallLanes*kSmallBatch slots, thread j loads slots u*kSmallLanes
// + j (u < kSmallBatch) and their operands, all in flight together; the
// products then pass by shuffle, so that every thread of the row adds them
// in list order, and thread 0 writes y[i].
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
routed_small_kernel(SmallArgs a, const float* __restrict__ x, long long n_x) {
  constexpr int kL = kSmallLanes, kRound = kSmallLanes * kSmallBatch;
  const long long gt = (long long)blockIdx.x * kSmallThreads + threadIdx.x;
  const long long i = gt / kL;
  const int j = (int)(gt % kL);
  if (i >= a.m) return;  // a row's threads leave together
  const unsigned row_mask = ((1u << kL) - 1) << (threadIdx.x % 32 / kL * kL);
  const T* __restrict__ vals = static_cast<const T*>(a.vals);
  const int p0 = __ldg(a.row_ptr + i), p1 = __ldg(a.row_ptr + i + 1);
  float acc = 0.f;
  for (int p = p0; p < p1; p += kRound) {
    int s[kSmallBatch];
#pragma unroll
    for (int u = 0; u < kSmallBatch; ++u) {
      const int q = p + u * kL + j;
      s[u] = q < p1 ? __ldg(a.row_slots + q) : -1;
    }
    float v[kSmallBatch];
    long long col[kSmallBatch];
#pragma unroll
    for (int u = 0; u < kSmallBatch; ++u) {
      if (s[u] >= 0) {
        v[u] = to_f32(vals[s[u]]);
        col[u] = (long long)__ldg(a.widx + s[u] / (kLane * kLane)) * kWindowElems +
                 (long long)a.pidx[s[u]] * kLane + (s[u] / kLane) % kLane;
      } else {
        v[u] = 0.f;
        col[u] = -1;
      }
    }
    float prod[kSmallBatch];
#pragma unroll
    for (int u = 0; u < kSmallBatch; ++u)
      prod[u] = __fmul_rn(v[u], (col[u] >= 0 && col[u] < n_x) ? __ldg(x + col[u]) : 0.f);
#pragma unroll
    for (int u = 0; u < kSmallBatch; ++u)
#pragma unroll
      for (int jj = 0; jj < kL; ++jj) {
        const float o = __shfl_sync(row_mask, prod[u], jj, kL);
        if (p + u * kL + jj < p1) acc = __fadd_rn(acc, o);
      }
  }
  if (j == 0) a.y[i] = acc;
}

size_t w_stage_smem(bool whole) {
  const int L = whole ? kLane : kBand;
  return (size_t)kLane * L * sizeof(float) + (size_t)L * kPitch;
}

int gather_launch(int vals_bf16, const void* vals, const int8_t* pidx, const int32_t* widx,
                  const int8_t* w1, int n_real, int n_tiles, const float* x, long long n_x,
                  float* out, cudaStream_t st) {
  const unsigned grid = (unsigned)n_tiles * (kLane / kBand);
  if (vals_bf16) {
    routed_gather_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)vals, pidx, widx, w1, n_real, x, n_x, out);
  } else {
    routed_gather_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)vals, pidx, widx, w1, n_real, x, n_x, out);
  }
  return (int)cudaGetLastError();
}

int w_stage_launch(const float* in, int in_rows, const int8_t* r, const int8_t* w,
                   const int8_t* ra, int t, int sw, int n_tiles, float* out,
                   long long out_limit, cudaStream_t st) {
  if (ra != nullptr) {
    // above 48 KB of dynamic shared memory; the attribute is per device, so
    // it is set on every launch (cheap, and allowed during graph capture)
    const cudaError_t e = cudaFuncSetAttribute(
        routed_w_stage_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)w_stage_smem(true));
    if (e != cudaSuccess) return (int)e;
    routed_w_stage_kernel<true><<<(unsigned)n_tiles, kThreads, w_stage_smem(true), st>>>(
        in, in_rows, r, w, ra, t, sw, out, out_limit);
  } else {
    routed_w_stage_kernel<false>
        <<<(unsigned)n_tiles * (kLane / kBand), kThreads, w_stage_smem(false), st>>>(
            in, in_rows, r, w, nullptr, t, sw, out, out_limit);
  }
  return (int)cudaGetLastError();
}

int perm_reduce_launch(const float* src, int src_rows, int mode, const int8_t* W,
                       const int8_t* r1, const int8_t* r3, const float* mask,
                       const int32_t* groups, int n_groups, float* out, cudaStream_t st) {
  routed_perm_reduce_kernel<<<(unsigned)n_groups, kLane, 0, st>>>(
      src, src_rows, mode, W, r1, r3, mask, reinterpret_cast<const int2*>(groups), out);
  return (int)cudaGetLastError();
}

int row_sums_launch(const float* part, const int32_t* ptr, const int32_t* idx, int seg,
                    const int32_t* dst, int n_rows, float* out, cudaStream_t st) {
  routed_row_sums_kernel<<<(unsigned)((n_rows + kRowWarps - 1) / kRowWarps), kRowWarps * 32, 0,
                           st>>>(part, ptr, idx, seg, dst, n_rows, out);
  return (int)cudaGetLastError();
}

// part: n_h * ceil(n_pad / kHChunk) f32 of scratch
int hdense_launch(const void* H, int n_h, long long n_pad, const float* x, long long n_x,
                  const int32_t* target, float* out, float* part, cudaStream_t st) {
  const int n_cta = (int)((n_pad + kHChunk - 1) / kHChunk);
  routed_hdense_kernel<<<dim3((unsigned)n_cta, (unsigned)n_h), kThreads, 0, st>>>(
      (const __nv_bfloat16*)H, n_pad, x, n_x, part);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return row_sums_launch(part, nullptr, nullptr, n_cta, target, n_h, out, st);
}

// part: n_tiles * 128 f32 of scratch
int heavy_launch(int vals_bf16, const void* hvals, const int8_t* hpidx, const int32_t* hwidx,
                 const int8_t* hlo, const int8_t* hhi, int n_tiles, const int32_t* slot_ptr,
                 const int32_t* slot_idx, const int32_t* rows, int n_h, const float* x,
                 long long n_x, float* part, float* out, cudaStream_t st) {
  const size_t smem = heavy_smem();
  // above 48 KB of dynamic shared memory; the attribute is per device, so
  // it is set on every launch (cheap, and allowed during graph capture)
  cudaError_t e;
  if (vals_bf16) {
    e = cudaFuncSetAttribute(routed_heavy_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      routed_heavy_kernel<__nv_bfloat16><<<(unsigned)n_tiles, kHeavyThreads, smem, st>>>(
          (const __nv_bfloat16*)hvals, hpidx, hwidx, hlo, hhi, x, n_x, part);
  } else {
    e = cudaFuncSetAttribute(routed_heavy_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      routed_heavy_kernel<float><<<(unsigned)n_tiles, kHeavyThreads, smem, st>>>(
          (const float*)hvals, hpidx, hwidx, hlo, hhi, x, n_x, part);
  }
  if (e != cudaSuccess) return (int)e;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return row_sums_launch(part, slot_ptr, slot_idx, 0, rows, n_h, out, st);
}

int small_launch(int vals_bf16, const SmallArgs& a, const float* x, long long n_x,
                 cudaStream_t st) {
  if (a.m <= 0) return 0;
  const unsigned grid = (unsigned)((a.m * kSmallLanes + kSmallThreads - 1) / kSmallThreads);
  if (vals_bf16) {
    routed_small_kernel<__nv_bfloat16><<<grid, kSmallThreads, 0, st>>>(a, x, n_x);
  } else {
    routed_small_kernel<float><<<grid, kSmallThreads, 0, st>>>(a, x, n_x);
  }
  return (int)cudaGetLastError();
}

// Program operands: a pointer is tagged in its top byte: 0 = absolute
// address (0 itself = null), 1 = scratch + offset, 2 = y + offset (byte
// offsets in the low 56 bits).
struct Bases {
  char* scratch;
  char* y;
};

void* resolve(long long v, const Bases& b) {
  const unsigned long long u = (unsigned long long)v;
  const long long off = (long long)(u & ((1ULL << 56) - 1));
  switch (u >> 56) {
    case 1: return b.scratch + off;
    case 2: return b.y + off;
    default: return (void*)off;
  }
}

enum Op {
  kOpGather = 1, kOpWStage = 2, kOpReduce = 3, kOpHDense = 4, kOpZero = 5, kOpHeavy = 6,
  kOpSmall = 7
};
constexpr int kOpWords[] = {0, 9, 11, 11, 7, 3, 14, 9};  // by op: the op and its operands

}  // namespace

extern "C" {

// Runs the len-entry program prog (ops with their operands, see
// routed_cuda.py::_op) on the stream: A (gather), B (W stage), C (perm
// reduce), D (dense heavy rows), E (pooled heavy tiles), the small kernel
// and memsets. counts[0..5] (host memory) gains one for each op of A, B, C,
// D, E and the small kernel that was enqueued without error (D and E: the
// kernel and its row sums). Returns the first error, or 0; nothing after it
// is enqueued.
int routed_chain_launch(const long long* prog, int len, const float* x, long long n_x,
                        float* y, void* scratch, int* counts, void* stream) {
  const Bases b{(char*)scratch, (char*)y};
  const cudaStream_t st = (cudaStream_t)stream;
  auto P = [&](int i) { return resolve(prog[i], b); };
  int i = 0;
  while (i < len) {
    const long long op = prog[i];
    if (op < kOpGather || op > kOpSmall || i + kOpWords[op] > len) return (int)cudaErrorInvalidValue;
    int rc, kernel = -1;
    switch ((int)op) {
      case kOpGather:  // vals_bf16 vals pidx widx w1 n_real n_tiles out
        rc = gather_launch((int)prog[i + 1], P(i + 2), (const int8_t*)P(i + 3),
                           (const int32_t*)P(i + 4), (const int8_t*)P(i + 5),
                           (int)prog[i + 6], (int)prog[i + 7], x, n_x, (float*)P(i + 8), st);
        kernel = 0;
        break;
      case kOpWStage:  // in in_rows r w ra t sw n_tiles out out_limit
        rc = w_stage_launch((const float*)P(i + 1), (int)prog[i + 2], (const int8_t*)P(i + 3),
                            (const int8_t*)P(i + 4), (const int8_t*)P(i + 5), (int)prog[i + 6],
                            (int)prog[i + 7], (int)prog[i + 8], (float*)P(i + 9),
                            prog[i + 10], st);
        kernel = 1;
        break;
      case kOpReduce:  // src src_rows mode W r1 r3 mask groups n_groups out
        rc = perm_reduce_launch((const float*)P(i + 1), (int)prog[i + 2], (int)prog[i + 3],
                                (const int8_t*)P(i + 4), (const int8_t*)P(i + 5),
                                (const int8_t*)P(i + 6), (const float*)P(i + 7),
                                (const int32_t*)P(i + 8), (int)prog[i + 9], (float*)P(i + 10),
                                st);
        kernel = 2;
        break;
      case kOpHDense:  // H n_h n_pad target out part
        rc = hdense_launch(P(i + 1), (int)prog[i + 2], prog[i + 3], x, n_x,
                           (const int32_t*)P(i + 4), (float*)P(i + 5), (float*)P(i + 6), st);
        kernel = 3;
        break;
      case kOpZero:  // ptr bytes
        rc = (int)cudaMemsetAsync(P(i + 1), 0, (size_t)prog[i + 2], st);
        break;
      case kOpHeavy:  // vals_bf16 hvals hpidx hwidx hlo hhi n_tiles slot_ptr slot_idx rows
                      // n_h part out
        rc = heavy_launch((int)prog[i + 1], P(i + 2), (const int8_t*)P(i + 3),
                          (const int32_t*)P(i + 4), (const int8_t*)P(i + 5),
                          (const int8_t*)P(i + 6), (int)prog[i + 7], (const int32_t*)P(i + 8),
                          (const int32_t*)P(i + 9), (const int32_t*)P(i + 10),
                          (int)prog[i + 11], x, n_x, (float*)P(i + 12), (float*)P(i + 13), st);
        kernel = 4;
        break;
      case kOpSmall: {  // vals_bf16 vals pidx widx row_ptr row_slots y m
        SmallArgs a;
        a.vals = P(i + 2);
        a.pidx = (const int8_t*)P(i + 3);
        a.widx = (const int32_t*)P(i + 4);
        a.row_ptr = (const int32_t*)P(i + 5);
        a.row_slots = (const int32_t*)P(i + 6);
        a.y = (float*)P(i + 7);
        a.m = prog[i + 8];
        rc = small_launch((int)prog[i + 1], a, x, n_x, st);
        kernel = 5;
        break;
      }
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
    if (kernel >= 0) ++counts[kernel];
    i += kOpWords[op];
  }
  return 0;
}

const char* routed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
