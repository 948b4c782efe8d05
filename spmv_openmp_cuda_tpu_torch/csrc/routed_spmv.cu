// Clos-routed SpMV kernels for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernels of spmv_openmp_cuda_tpu/formats/routed.py and
// spmv_openmp_cuda_tpu/ops/route.py:
//   routed_gather_kernel       (A) <- _gather_w1 (pallas_call at :959, :1005)
//                                     and, with W1 off, _gather_products (:910)
//   routed_permute_kernel      (B) <- ops/route.py::_whole_w_call (:347) and
//                                     _tiled_call (:298): a whole planned
//                                     permutation (or one W stage) as one
//                                     gather through a composed index map
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
// These stages are static, so the host composes every chain of them that a
// product applies (routed_cuda.py::plan_map, on int64 element ids) into one
// int32 index map: element i of the result is element map[i] of the source,
// or zero where map[i] is -1 (a source row past the rows that hold data, a
// pad tile). B and C read through such maps; no kernel applies a W stage.
//
// What bounds them: the chain on caida_like moves ~25 MB per product, most
// of it inside the 50 MB L2, so latency and scattered L2 sectors as much as
// bytes:
//   - A takes one CTA per (128-row tile, band of 32 lanes): the band's 128 x
//     32 products and its 32 W1 index rows are staged in shared memory with
//     row-contiguous loads; the output tile is then written row by row.
//   - B gathers out[i] = src[map[i]]: each thread issues the map loads of
//     its kPermBatch elements, then their source loads, then its coalesced
//     stores, so two round trips serve kPermBatch elements. The output
//     permutation of a domain is one launch into y (every y[i] written, the
//     heavy rows as zero for E to add into).
//   - C takes, per output group (a run of `width` slab rows) and lane l, the
//     sum of the group's slab slots at lane l, each read through its one
//     composed offset straight from the source (the products of A, or the
//     sums of the level before), masked on a level. A thread issues the
//     offset (and mask) loads of kReduceBatch rows, then their value loads,
//     and the next batch's offset loads before it adds the values in row
//     order, one __fadd_rn after another from +0 (the order of the plain
//     W-stage chain's C, so y is bit for bit what that chain gives). A
//     128-row group is then ~9 round trips, not one per row and stage. The
//     narrow groups are packed into chunks of ~32 rows, which a thread
//     streams as one run of rows (closing each group at its last row), so
//     that a CTA's fixed round trips serve more than a few rows; a CTA is
//     one warp over one chunk's band of 32 lanes, so a wide group's four
//     bands run on four SMs. Wide groups come first, so they start first.
//     What bounds it: the value reads, one 32-byte L2 sector per 4-byte
//     slot, scattered by the routing (on an H100 ~12 us for caida_like's
//     ~850,000).
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
//   - The small kernel composes the whole chain. build_chain runs element
//     ids through its index maps and folds in C's groups: each row i of y
//     gets the gather slots whose products C adds into it, in C's order, as
//     a per-row slot list (row_slots[row_ptr[i] .. row_ptr[i+1]), at most
//     h1*128 int32). The kSmallLanes threads of a row then load a round of
//     16 of its slots (each thread four), the slots' values and panels, then
//     x: three dependent round trips after row_ptr, no slab in between, no
//     barrier, CTAs of 64 threads so that the rows spread over many SMs. The
//     products pass by shuffle, and each of the row's threads adds them one
//     at a time in list order. Products and adds are __fmul_rn/__fadd_rn
//     (never contracted into an FMA), as A multiplies and C adds, so y
//     equals the staged chain's bit for bit. Bound: latency, the scattered
//     loads of the slots' operands and of x (delaunay's ~0.6 MB stay in
//     L2): four threads per row keep four times the loads in flight that
//     one thread would.
// Nothing closes with atomics: every sum is taken in an order fixed by the
// layout, so a rerun is bitwise equal. x is read by global column behind a
// bounds test against n (no padded window stack is built). Products and
// data movement are exact, so A and B equal their plain versions bit for
// bit; C, D and E sum in another order than theirs.
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
constexpr int kBand = 32;             // lanes per CTA of A and of C
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
constexpr int kPermBatch = 4;              // B: elements whose loads a thread issues together
constexpr int kReduceBatch = 16;           // C: slab rows whose loads a thread issues together
constexpr int kChunkGroups = 128;          // C: at most this many groups per CTA (routed_cuda.py)

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

// B: out[i] = map[i] >= 0 ? src[map[i]] : 0 for i < n. Thread t of CTA b
// takes i = b*kThreads*kPermBatch + u*kThreads + t (u < kPermBatch): the map
// loads and the stores are coalesced, the source loads scattered inside an
// L2-resident domain; all of a thread's loads of one kind are issued before
// the first of the next kind is used.
__global__ void __launch_bounds__(kThreads)
routed_permute_kernel(const float* __restrict__ src, const int32_t* __restrict__ map,
                      long long n, float* __restrict__ out) {
  const long long i0 = (long long)blockIdx.x * (kThreads * kPermBatch) + threadIdx.x;
  int o[kPermBatch];
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) {
    const long long i = i0 + (long long)u * kThreads;
    o[u] = i < n ? __ldg(map + i) : -1;
  }
  float v[kPermBatch];
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) v[u] = o[u] >= 0 ? __ldg(src + o[u]) : 0.f;
#pragma unroll
  for (int u = 0; u < kPermBatch; ++u) {
    const long long i = i0 + (long long)u * kThreads;
    if (i < n) out[i] = v[u];
  }
}

// C's offsets (and, with kMask, mask) of rows [k0, k0 + kReduceBatch) of a
// chunk of n rows at lane l (off_l, mask_l: the chunk's first row at lane
// l); rows past the chunk read as offset -1.
template <bool kMask>
__device__ __forceinline__ void reduce_batch(const int32_t* __restrict__ off_l,
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

// C: out[g, l] = sum over k < width_g of g(row0_g + k, l), added in k order
// from +0, with g(rr, l) = (mask ? mask[rr, l] : 1) * (off[rr, l] >= 0 ?
// src[off[rr, l]] : 0); groups[g] = (row0, width). CTA 4c + b, one warp,
// takes lanes 32b .. 32b + 31 of chunk c = (row0, row1, g0, g1): the groups
// g0 .. g1 - 1, whose rows tile [row0, row1) in order. Lane l streams those
// rows in batches, closing each group's sum at its last row.
template <bool kMask>
__global__ void __launch_bounds__(kBand)
routed_perm_reduce_kernel(const float* __restrict__ src, const int32_t* __restrict__ off,
                          const float* __restrict__ mask, const int2* __restrict__ groups,
                          const int4* __restrict__ chunks, float* __restrict__ out) {
  constexpr int kBands = kLane / kBand;
  __shared__ int ends[kChunkGroups];  // each group's last row + 1, from the chunk's first row
  const int4 ch = chunks[blockIdx.x / kBands];
  const int l = (blockIdx.x % kBands) * kBand + threadIdx.x;
  const int n = ch.y - ch.x;
  const long long e0 = (long long)ch.x * kLane + l;
  const int32_t* off_l = off + e0;
  const float* mask_l = kMask ? mask + e0 : nullptr;
  int o[kReduceBatch];
  float mk[kReduceBatch];
  reduce_batch<kMask>(off_l, mask_l, 0, n, o, mk);
  for (int j = threadIdx.x; j < ch.w - ch.z; j += kBand) {
    const int2 g = groups[ch.z + j];
    ends[j] = g.x + g.y - ch.x;
  }
  __syncthreads();
  int g = ch.z, end = ends[0];
  float acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kReduceBatch) {
    float v[kReduceBatch], m[kReduceBatch];
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      v[u] = o[u] >= 0 ? __ldg(src + o[u]) : 0.f;
      if (kMask) m[u] = mk[u];
    }
    // the next batch's offsets travel while this batch's values do
    reduce_batch<kMask>(off_l, mask_l, k0 + kReduceBatch, n, o, mk);
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      if (k0 + u >= n) break;
      acc = __fadd_rn(acc, kMask ? __fmul_rn(v[u], m[u]) : v[u]);
      if (k0 + u + 1 == end) {
        out[(long long)g * kLane + l] = acc;
        acc = 0.f;
        if (++g < ch.w) end = ends[g - ch.z];
      }
    }
  }
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

int permute_launch(const float* src, const int32_t* map, long long n, float* out,
                   cudaStream_t st) {
  const long long per_cta = (long long)kThreads * kPermBatch;
  routed_permute_kernel<<<(unsigned)((n + per_cta - 1) / per_cta), kThreads, 0, st>>>(src, map, n,
                                                                                     out);
  return (int)cudaGetLastError();
}

// a one-warp CTA per (chunk, band of 32 lanes): a wide group's lanes spread
// over four SMs
int perm_reduce_launch(const float* src, const int32_t* off, const float* mask,
                       const int32_t* groups, const int32_t* chunks, int n_chunks, float* out,
                       cudaStream_t st) {
  const unsigned grid = (unsigned)n_chunks * (kLane / kBand);
  const int2* g = reinterpret_cast<const int2*>(groups);
  const int4* c = reinterpret_cast<const int4*>(chunks);
  if (mask != nullptr) {
    routed_perm_reduce_kernel<true><<<grid, kBand, 0, st>>>(src, off, mask, g, c, out);
  } else {
    routed_perm_reduce_kernel<false><<<grid, kBand, 0, st>>>(src, off, mask, g, c, out);
  }
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
  kOpGather = 1, kOpPermute = 2, kOpReduce = 3, kOpHDense = 4, kOpZero = 5, kOpHeavy = 6,
  kOpSmall = 7
};
constexpr int kOpWords[] = {0, 9, 5, 8, 7, 3, 14, 9};  // by op: the op and its operands

}  // namespace

extern "C" {

// Runs the len-entry program prog (ops with their operands, see
// routed_cuda.py::_op) on the stream: A (gather), B (permute), C (perm
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
      case kOpPermute:  // src map n out
        rc = permute_launch((const float*)P(i + 1), (const int32_t*)P(i + 2), prog[i + 3],
                            (float*)P(i + 4), st);
        kernel = 1;
        break;
      case kOpReduce:  // src off mask groups chunks n_chunks out
        rc = perm_reduce_launch((const float*)P(i + 1), (const int32_t*)P(i + 2),
                                (const float*)P(i + 3), (const int32_t*)P(i + 4),
                                (const int32_t*)P(i + 5), (int)prog[i + 6], (float*)P(i + 7), st);
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
