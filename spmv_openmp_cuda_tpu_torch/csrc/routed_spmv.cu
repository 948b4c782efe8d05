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
//   routed_row_sums_kernel         closes E: per heavy row, its slot sums
//                                     added in a fixed order
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
//   - A: each product reads x in its tile's 16,384-element window; read
//     from global memory, each would cost a 32-byte L2 sector of its own.
//     So a CTA copies the window (64 KB) into shared memory by one bulk
//     asynchronous copy (1-D TMA, completing on an mbarrier) and takes two
//     bands of 32 lanes of the tile in turn over it: the L2 serves the
//     window twice per tile, not 16,384 scattered sectors. Every load of a
//     band (its vals and pidx rows, its W1 index rows, 16 bytes a thread)
//     is issued before the window is waited for, or before the band before
//     it is multiplied. A thread forms the products of one tile row s (x
//     read from the window at bank s % 32: a warp's 32 rows hit 32 banks),
//     stores them in a swizzled (128, 32) tile, and the band's output tile
//     is written row by row through W1. Measured on an H100 (PERF.md): a
//     cluster of the tile's four band CTAs with the window multicast into
//     each, or a CTA per band, ran slower on webbase_like (each SM still
//     takes in a 64 KB window per CTA); A writing its products straight
//     into C's slab order lost 4x (the scattered sectors moved into its
//     stores).
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
//   - D is one launch. A CTA takes one chunk of kHChunk columns of a group
//     of heavy rows (up to kHRows, halved while the CTAs would be fewer than
//     half the SMs: caida_like's 8 rows and 47 chunks run as 94 CTAs of 4
//     rows): each thread reads x at its 16 columns once, into registers, for
//     all of the group's rows, then issues every row's 16-byte loads of bf16
//     H before the products. A (row, chunk) sum is the thread's 16 products
//     fused into its sum from +0 (__fmaf_rn) in column order, then the
//     warp's shuffle tree, then the tree of the 8 warp sums, into part[row *
//     chunks + chunk]. Each CTA then takes a ticket (atomicAdd after
//     __threadfence); the last one closes the product: warp w adds heavy row
//     k's chunk sums, spread over its 32 lanes in turn from +0, by the
//     shuffle tree into out[target[k]] (target and out loaded by every CTA
//     at its start), and resets the ticket (zero between launches, so a CUDA
//     graph replays). These are the adds, in their order, of the two
//     launches (a CTA per row and chunk, then a close) that D was before, so
//     y did not change (routed_cuda.py::hdense_in_order). Measured on an
//     H100 (scripts/torch_routed_probe.py --kernel D, PERF.md): 4.5 us in a
//     graph on caida_like against 5.0 before; all 8 rows per CTA 5.2, one
//     row per CTA 6.5; the close ~0.9 us of it (its ticket, the sums' round
//     trip).
//   - E takes work items (pooled tile T, residue quarter q) in persistent
//     CTAs of 128 threads, two per SM. An item's rows T*128 + 32q .. +31
//     (residues a) of hvals, hpidx, hlo and hhi are contiguous, and the x
//     they read is the window's 128 segments of 32 floats (columns
//     hwidx[T]*16384 + p*128 + 32q .. +31): all of it is copied into one of
//     the CTA's two stage buffers by 16-byte cp.async (zero past n_x), the
//     next item's copies in flight while this item's sums are taken, so E
//     reads about the bytes its bound counts and no 32-byte sector per
//     product. Residue a's runs (lanes (hlo, hhi] of row slot j) become
//     lane flags (one writer per flag byte: the runs are disjoint); the
//     products go in place as f32; then residue a's lanes are walked in
//     four segments, thread (a, segment) summing the runs that start in its
//     segment to their ends (16 lanes a chunk: the chunk's starts and ends
//     as lane masks, one select and one add a lane), each sum left in its
//     run's last lane. Thread j then adds slot j's run sums over the
//     quarter's residues in order, into part[(T*128 + j)*4 + q];
//     routed_row_sums_kernel adds a slot's four quarters in order, then each
//     heavy row's slots, into y: the adds of routed_cuda.py::
//     heavy_sums_in_order in its order (a CTA per whole tile adds the same
//     way), so y does not depend on the split. The TPU's cumsum by
//     triangular matmul and its differences are a device of the MXU; the
//     sums here are direct. Bound: bytes (hvals, hpidx, hlo, hhi and x, ~27
//     MB per product on webbase_like); the walk's chain of dependent adds
//     (a run of up to 128 lanes) is the longest path of an item.
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
// No sum is taken with atomics (D finds its last CTA by an atomic ticket,
// which then adds in a fixed order): every sum is taken in an order fixed
// by the layout, so a rerun is bitwise equal. x is read by global column behind a
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
constexpr int kThreads = 256;
constexpr long long kWindowElems = 128LL * 128;
constexpr int kGatherBands = 2;            // A: bands of a tile one CTA takes in turn
constexpr int kHChunk = kThreads * 8 * 2;  // columns of H per CTA of D
constexpr int kHRows = kThreads / 32;      // D: heavy rows per CTA at most (a warp closes each)
constexpr int kCloseRows = 64 / kHRows;    // D: heavy rows a warp of the close takes (n_h <= 64)
constexpr int kQuarters = 4;               // E: CTAs per pooled tile, one per residue quarter
constexpr int kQuarter = kLane / kQuarters;  // E: residues per CTA
constexpr int kHeavyThreads = kLane;       // E: a thread per slot (and per lane)
constexpr int kHvPitch = 528;  // E: bytes per staged hvals row (33 16-byte chunks: spreads banks)
constexpr int kPxPitch = 144;  // E: bytes per staged hpidx row (9 16-byte chunks)
constexpr int kWalkSegs = 4;   // E: lane segments of a residue walked at once (one warp each)
constexpr int kHeavyCtasPerSm = 2;  // E: persistent CTAs per SM (two stage buffers each)
constexpr int kSmallLanes = 4;             // threads per row of y of the small kernel
constexpr int kSmallBatch = 4;             // list slots whose loads such a thread issues together
constexpr int kSmallThreads = 64;          // threads per CTA of the small kernel
constexpr int kRowWarps = 8;               // heavy rows per CTA of E's row sums
constexpr int kPermBatch = 4;              // B: elements whose loads a thread issues together
constexpr int kReduceBatch = 16;           // C: slab rows whose loads a thread issues together
constexpr int kChunkGroups = 128;          // C: at most this many groups per CTA (routed_cuda.py)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of one thread (cp.async): 16 bytes, of which the
// first src_bytes come from src and the rest are zero (src_bytes 0: src is
// not read); 4 bytes likewise. Neither holds registers while in flight;
// cp.async.commit_group / wait_group fence them.
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@!P1 bra LAB_WAIT;\n\t}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 16 values of type T at p (16-byte aligned, global or shared) as f32.
template <typename T>
struct Vec16 {
  uint4 w[16 * sizeof(T) / 16];
  __device__ __forceinline__ void load(const void* p) {
#pragma unroll
    for (int k = 0; k < 16 * (int)sizeof(T) / 16; ++k) w[k] = reinterpret_cast<const uint4*>(p)[k];
  }
  __device__ __forceinline__ float operator[](int k) const {
    return to_f32(reinterpret_cast<const T*>(w)[k]);
  }
};

constexpr size_t kGatherSmem = (size_t)kWindowElems * 4 + (size_t)kLane * kBand * 4 + 16;

// A's operands of one band of a tile for thread (s, h): row s's vals and
// pidx at lanes band*32 + 16h .. +15, and for thread (lb, g) W1 row
// i*128 + band*32 + lb at j = 16g .. 16g + 15, 16 bytes a load.
template <typename T>
struct GatherBand {
  Vec16<T> v;
  uint4 p, w;
  __device__ __forceinline__ void load(const T* __restrict__ vals, const int8_t* __restrict__ pidx,
                                       const int8_t* __restrict__ w1, long long base, int band,
                                       int s, int h, int lb, int g) {
    const long long e = base + (long long)s * kLane + band * kBand + 16 * h;
    v.load(vals + e);
    p = *reinterpret_cast<const uint4*>(pidx + e);
    w = w1 != nullptr ? *reinterpret_cast<const uint4*>(
                            w1 + base + (long long)(band * kBand + lb) * kLane + 16 * g)
                      : make_uint4(0, 0, 0, 0);
  }
};

// A: out tile i, lane l = band*32 + lb, row j:
//   s = w1 ? w1[i*128 + l, j] : j
//   out[i*128 + j, l] = vals[i*128 + s, l] * x[widx[i]*16384 + pidx[i*128 + s, l]*128 + s]
// and zeros for the pad tiles i >= n_real. A CTA takes kGatherBands
// consecutive bands of a tile, one after another over the window it holds.
// vals, pidx and w1 are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
routed_gather_kernel(const T* __restrict__ vals, const int8_t* __restrict__ pidx,
                     const int32_t* __restrict__ widx, const int8_t* __restrict__ w1,
                     int n_real, const float* __restrict__ x, long long n_x,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xw = reinterpret_cast<float*>(smem);  // the window: x[x0 + p*128 + s] at p*128 + s
  float* pr = xw + kWindowElems;               // products: row s, lane lb at s*32 + (lb ^ s%32)
  uint64_t* bar = reinterpret_cast<uint64_t*>(pr + kLane * kBand);
  constexpr int kB = kGatherBands;
  constexpr int kCtas = kLane / kBand / kB;    // CTAs per tile
  const int tid = threadIdx.x;
  const int tile = blockIdx.x / kCtas;
  const int band0 = blockIdx.x % kCtas * kB;
  const long long base = (long long)tile * kLane * kLane;
  const int lb = tid % kBand, g = tid / kBand;  // output: lane lb, rows 16g .. 16g + 15
  if (tile >= n_real) {
    for (int b = band0; b < band0 + kB; ++b)
      for (int j = g; j < kLane; j += kThreads / kBand)
        out[base + (long long)j * kLane + b * kBand + lb] = 0.f;
    return;
  }
  // every load of the first band is issued before the window is waited
  // for, and each next band's before this band's products
  const int s = tid % kLane, h = tid / kLane;  // products: row s, lanes 16h .. 16h + 15
  GatherBand<T> cur;
  cur.load(vals, pidx, w1, base, band0, s, h, lb, g);
  // the window: its 16-byte-aligned part inside x by one bulk copy (with x
  // 16-byte aligned), completing on the mbarrier; the rest (a tail under 16
  // bytes, zeros past n_x) by the threads
  const long long x0 = (long long)__ldg(widx + tile) * kWindowElems;
  const long long cnt = max(0LL, min(kWindowElems, n_x - x0));
  const int bulk = (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? (int)(cnt & ~3LL) : 0;
  const uint32_t b = smem_addr(bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(bulk * 4)
                 : "memory");
    if (bulk > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(xw)),
          "l"(reinterpret_cast<uint64_t>(x + x0)), "r"((uint32_t)bulk * 4), "r"(b)
          : "memory");
  }
  for (int k = bulk + tid; k < (int)kWindowElems; k += kThreads)
    xw[k] = k < cnt ? __ldg(x + x0 + k) : 0.f;
  mbar_wait(b, 0);
  __syncthreads();
#pragma unroll
  for (int kb = 0; kb < kB; ++kb) {
    GatherBand<T> nxt;
    if (kb + 1 < kB) nxt.load(vals, pidx, w1, base, band0 + kb + 1, s, h, lb, g);
    const unsigned char* pb = reinterpret_cast<const unsigned char*>(&cur.p);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      pr[s * kBand + ((16 * h + k) ^ (s % kBand))] = __fmul_rn(cur.v[k], xw[pb[k] * kLane + s]);
    __syncthreads();
    const unsigned char* wb = reinterpret_cast<const unsigned char*>(&cur.w);
    float* o = out + base + (band0 + kb) * kBand + lb;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int j = 16 * g + k;
      const int r = w1 != nullptr ? (int)wb[k] : j;
      o[(long long)j * kLane] = pr[r * kBand + (lb ^ (r % kBand))];
    }
    if (kb + 1 < kB) {
      __syncthreads();  // the next band's products overwrite pr
      cur = nxt;
    }
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

// The shuffle tree of a warp: lane 0 gets ((v0 + v16) + (v8 + v24)) + ...
__device__ __forceinline__ float warp_tree(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// D: out[target[k]] += sum over c of f32(H[k, c]) * x[c] (x zero past n_x;
// n_pad a multiple of 128). CTA (chunk, g) takes the columns [chunk *
// kHChunk, + kHChunk) of heavy rows g * rows .. + rows; its (row, chunk)
// sums go to part[k * gridDim.x + chunk]; the last CTA to take a ticket
// adds each row's sums into out and sets the ticket back to 0.
__global__ void __launch_bounds__(kThreads)
routed_hdense_kernel(const __nv_bfloat16* __restrict__ H, int n_h, long long n_pad, int rows,
                     const float* __restrict__ x, long long n_x,
                     const int32_t* __restrict__ target, float* __restrict__ out,
                     float* __restrict__ part, unsigned* __restrict__ ticket) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * rows;
  const int nr = min(rows, n_h - k0);
  // what a close reads besides the sums, loaded by every CTA while its own
  // loads fly (lane 0 of warp w: the rows w, w + 8, ... up to n_h <= 64);
  // out holds the memset's zeros: no CTA writes it before the close
  int tk[kCloseRows];
  float ok[kCloseRows];
#pragma unroll
  for (int j = 0; j < kCloseRows; ++j) {
    const int k = warp + j * (kThreads / 32);
    tk[j] = lane == 0 && k < n_h ? __ldg(target + k) : 0;
    ok[j] = lane == 0 && k < n_h ? out[tk[j]] : 0.f;
  }
  // x at this thread's columns c[it] .. + 7, read once for the group's rows
  const bool vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  long long c[2];
  float xv[2][8];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    c[it] = (long long)blockIdx.x * kHChunk + ((long long)it * kThreads + threadIdx.x) * 8;
    if (vec_x && c[it] + 8 <= n_x) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + c[it]));
      const float4 b = __ldg(reinterpret_cast<const float4*>(x + c[it] + 4));
      xv[it][0] = a.x, xv[it][1] = a.y, xv[it][2] = a.z, xv[it][3] = a.w;
      xv[it][4] = b.x, xv[it][5] = b.y, xv[it][6] = b.z, xv[it][7] = b.w;
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) xv[it][u] = c[it] + u < n_x ? __ldg(x + c[it] + u) : 0.f;
    }
  }
  // every row's 16-byte loads of H before the first product
  uint4 hv[kHRows][2];
#pragma unroll
  for (int r = 0; r < kHRows; ++r)
#pragma unroll
    for (int it = 0; it < 2; ++it)
      if (r < nr && c[it] < n_pad)
        hv[r][it] = __ldg(reinterpret_cast<const uint4*>(H + (long long)(k0 + r) * n_pad + c[it]));
  __shared__ float warp_sums[kHRows][kThreads / 32];
#pragma unroll
  for (int r = 0; r < kHRows; ++r) {
    if (r >= nr) break;
    float acc = 0.f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      if (c[it] < n_pad) {
        const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&hv[r][it]);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = __fmaf_rn(__bfloat162float(hb[u]), xv[it][u], acc);
      }
    }
    acc = warp_tree(acc);
    if (lane == 0) warp_sums[r][warp] = acc;
  }
  __syncthreads();
  if (warp < nr) {
    const float v = warp_tree(lane < kThreads / 32 ? warp_sums[warp][lane] : 0.f);
    if (lane == 0) part[(long long)(k0 + warp) * gridDim.x + blockIdx.x] = v;
  }
  // the CTA that takes the last ticket has every other CTA's sums (the
  // fence after the barrier makes the CTA's sums visible before its ticket)
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_cta = gridDim.x;
#pragma unroll
  for (int j = 0; j < kCloseRows; ++j) {
    const int k = warp + j * (kThreads / 32);
    if (k >= n_h) break;
    float acc = 0.f;
    for (int i = lane; i < n_cta; i += 32) acc += __ldcg(part + (long long)k * n_cta + i);
    acc = warp_tree(acc);
    if (lane == 0) out[tk[j]] = ok[j] + acc;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// E's close, one warp per heavy row k: out[dst[k]] += the sum of the slots
// idx[ptr[k] .. ptr[k + 1]), lane by lane and then by the shuffle tree; a
// slot's value is its four residue quarters added in order, ((part[4s] +
// part[4s+1]) + part[4s+2]) + part[4s+3] (part 16-byte aligned).
__global__ void __launch_bounds__(kRowWarps * 32)
routed_row_sums_kernel(const float* __restrict__ part, const int32_t* __restrict__ ptr,
                       const int32_t* __restrict__ idx, const int32_t* __restrict__ dst,
                       int n_rows, float* __restrict__ out) {
  const int k = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (k >= n_rows) return;  // a whole warp
  const long long b = ptr[k], e = ptr[k + 1];
  float acc = 0.f;
  for (long long i = b + lane; i < e; i += 32) {
    const float4 r = reinterpret_cast<const float4*>(part)[idx[i]];
    acc += __fadd_rn(__fadd_rn(__fadd_rn(r.x, r.y), r.z), r.w);
  }
  acc = warp_tree(acc);
  if (lane == 0) out[dst[k]] += acc;
}

// E's staged operands of one (tile, quarter): residue a's row of hvals at
// byte kVOff of hv[a] (f32 from 0, bf16 from 256), then its products as f32
// lanes from byte 0, then each run's sum in the run's last lane; hpidx,
// hlo and hhi rows; x of panel p, residue a at xs[p*32 + a].
struct HeavyStageBuf {
  unsigned char hv[kQuarter * kHvPitch];
  unsigned char px[kQuarter * kPxPitch];
  signed char lo[kQuarter * kLane];
  signed char hi[kQuarter * kLane];
  float xs[kLane * kQuarter];
};
constexpr size_t kHeavySmem = 2 * sizeof(HeavyStageBuf) + kQuarter * kPxPitch;

// Issue the 16-byte cp.async copies of item (tile, q)'s operands into b
// (x zero past n_x; hw: the tile's window).
template <typename T>
__device__ __forceinline__ void heavy_issue(HeavyStageBuf& b, const T* __restrict__ hvals,
                                            const int8_t* __restrict__ hpidx,
                                            const int8_t* __restrict__ hlo,
                                            const int8_t* __restrict__ hhi,
                                            const float* __restrict__ x, long long n_x, int tile,
                                            int q, int hw) {
  constexpr int kVBytes = kLane * (int)sizeof(T), kVOff = kLane * 4 - kVBytes;
  const int tid = threadIdx.x;
  const long long row0 = (long long)tile * kLane + q * kQuarter;
  const long long x0 = (long long)hw * kWindowElems + q * kQuarter;
  const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(hvals + row0 * kLane);
  for (int c = tid; c < kQuarter * kVBytes / 16; c += kHeavyThreads) {
    const int r = c / (kVBytes / 16), k = c % (kVBytes / 16);
    cp16(b.hv + r * kHvPitch + kVOff + 16 * k, vsrc + (long long)r * kVBytes + 16 * k);
  }
  for (int c = tid; c < kQuarter * kLane / 16; c += kHeavyThreads) {
    const int r = c / (kLane / 16), k = 16 * (c % (kLane / 16));
    const long long e = (row0 + r) * kLane + k;
    cp16(b.px + r * kPxPitch + k, hpidx + e);
    cp16(b.lo + r * kLane + k, hlo + e);
    cp16(b.hi + r * kLane + k, hhi + e);
  }
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    for (int c = tid; c < kLane * kQuarter / 4; c += kHeavyThreads) {
      const int p = c / (kQuarter / 4), k = 4 * (c % (kQuarter / 4));
      const long long col = x0 + (long long)p * kLane + k;
      const int in = (int)max(0LL, min(4LL, n_x - col));
      cp16(b.xs + p * kQuarter + k, in > 0 ? x + col : x, 4 * in);
    }
  } else {
    for (int c = tid; c < kLane * kQuarter; c += kHeavyThreads) {
      const long long col = x0 + (long long)(c / kQuarter) * kLane + c % kQuarter;
      cp4(b.xs + c, col < n_x ? x + col : x, col < n_x ? 4 : 0);
    }
  }
}

// The sums of item (tile, q) from its staged operands b; fl: the lane flags
// (zero on entry, zero again on return after the caller's next barrier).
template <typename T>
__device__ __forceinline__ void heavy_sums(HeavyStageBuf& b, unsigned char* fl_s, int tile,
                                           int q, float* __restrict__ part) {
  constexpr int kVBytes = kLane * (int)sizeof(T), kVOff = kLane * 4 - kVBytes;
  const int tid = threadIdx.x;
  {  // the lane flags of residue fa's runs in slots fj .. fj + 31: a run (lo,
     // hi] starts at lane lo + 1 and ends at hi; runs are disjoint, so each
     // flag byte has one writer (a slot without a run writes the row's pad
     // bytes 128 and 129, which nothing reads)
    const int fa = tid / 4, fj = 32 * (tid % 4);
    const uint4* lo4 = reinterpret_cast<const uint4*>(b.lo + fa * kLane + fj);
    const uint4* hi4 = reinterpret_cast<const uint4*>(b.hi + fa * kLane + fj);
    const uint4 lo_v[2] = {lo4[0], lo4[1]}, hi_v[2] = {hi4[0], hi4[1]};
    const signed char* lo_b = reinterpret_cast<const signed char*>(lo_v);
    const signed char* hi_b = reinterpret_cast<const signed char*>(hi_v);
    unsigned char* fl = fl_s + fa * kPxPitch;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int hi = hi_b[u], lo = lo_b[u] + 1;
      const bool run = hi >= 0;
      fl[run ? lo : kLane] = 1;
      fl[run ? hi : kLane + 1] = lo == hi ? 3 : 2;  // after the start: a one-lane run is both
    }
  }
  const int a = tid % kQuarter, lq = tid / kQuarter;  // residue a; lanes 32lq .. 32lq + 31
  float* prow = reinterpret_cast<float*>(b.hv + a * kHvPitch);
  {  // the products of residue a's lanes 32lq .. +31, in place as f32
    float pr[32];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      Vec16<T> v;
      v.load(b.hv + a * kHvPitch + kVOff + (32 * lq + 16 * c) * (int)sizeof(T));
      const uint4 pv = *reinterpret_cast<const uint4*>(b.px + a * kPxPitch + 32 * lq + 16 * c);
      const unsigned char* pb = reinterpret_cast<const unsigned char*>(&pv);
#pragma unroll
      for (int k = 0; k < 16; ++k) pr[16 * c + k] = __fmul_rn(v[k], b.xs[pb[k] * kQuarter + a]);
    }
    if (sizeof(T) < 4) __syncthreads();  // a row's f32 products cover its bf16 values
#pragma unroll
    for (int k = 0; k < 32; k += 4)
      *reinterpret_cast<float4*>(prow + 32 * lq + k) =
          make_float4(pr[k], pr[k + 1], pr[k + 2], pr[k + 3]);
  }
  __syncthreads();
  {  // residue a's lanes in order, in kWalkSegs segments: thread (a, seg)
     // sums the runs that start in its segment, to their ends
    constexpr int kSegLanes = kLane / kWalkSegs;
    const int seg = lq;
    if (seg < kWalkSegs) {
      const int c0 = seg * kSegLanes / 16, c1 = (seg + 1) * kSegLanes / 16;
      const float4* prow4 = reinterpret_cast<const float4*>(prow);
      const uint4* fl4 = reinterpret_cast<const uint4*>(fl_s + a * kPxPitch);
      float4 pv[4];
      uint4 fv;
#pragma unroll
      for (int k = 0; k < 4; ++k) pv[k] = prow4[4 * c0 + k];
      fv = fl4[c0];
      float acc = 0.f;
      bool seen = false, open = false;  // a start in the segment; inside a run not yet ended
      for (int c = c0; c < kLane / 16; ++c) {
        const bool more = c < c1;
        if (!__any_sync(0xffffffffu, open || more)) break;
        const float4 cur[4] = {pv[0], pv[1], pv[2], pv[3]};
        const uint32_t fw[4] = {fv.x, fv.y, fv.z, fv.w};
        if (c + 1 < kLane / 16) {  // the next chunk in flight while this one is summed
#pragma unroll
          for (int k = 0; k < 4; ++k) pv[k] = prow4[4 * (c + 1) + k];
          fv = fl4[c + 1];
        }
        asm volatile("" ::: "memory");  // those loads stay ahead of this chunk's stores
        // the chunk's starts and ends as 16-bit lane masks
        uint32_t st = 0, en = 0;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          st |= (((fw[w] & 0x01010101u) * 0x01020408u) >> 24) << (4 * w);
          en |= ((((fw[w] >> 1) & 0x01010101u) * 0x01020408u) >> 24) << (4 * w);
        }
        // the ends this thread writes: in its segment, those of runs that
        // start there (after its first start); past it, the end of the run
        // it still has open, and none after
        uint32_t own;
        if (more) {
          const uint32_t from = seen ? 0xffffu : (st ? (0xffffu & ~((st & (0u - st)) - 1u)) : 0u);
          own = en & from;
          seen = seen || st != 0;
        } else {
          own = open ? en & (0u - en) : 0u;
        }
        // inside a run it owns after this chunk: in its segment, when the
        // chunk's last start is after its last end (a one-lane run starts
        // and ends on one lane); past it, until that run's end
        const int hs = 31 - __clz(st), he = 31 - __clz(en);
        open = more ? hs > he || (hs == he && hs < 0 && open) : open && own == 0u;
        const float* pf = reinterpret_cast<const float*>(cur);
#pragma unroll
        for (int k = 0; k < 16; ++k) {  // one select and one add a lane
          acc = __fadd_rn((st >> k) & 1u ? 0.f : acc, pf[k]);
          if ((own >> k) & 1u) prow[16 * c + k] = acc;
        }
      }
    }
  }
  __syncthreads();
  // the flags back to zero for the next item (no thread reads them now)
  for (int c = tid; c < kQuarter * kPxPitch / 16; c += kHeavyThreads)
    reinterpret_cast<uint4*>(fl_s)[c] = make_uint4(0, 0, 0, 0);
  // slot tid: its runs over the quarter's residues in order (the loads
  // first: all 32 run sums in flight before the first add)
  float run[kQuarter];
#pragma unroll
  for (int r = 0; r < kQuarter; ++r) {
    const int hi = b.hi[r * kLane + tid];
    run[r] = hi >= 0 ? reinterpret_cast<const float*>(b.hv + r * kHvPitch)[hi] : 0.f;
  }
  float acc = 0.f;  // +0 for a residue without a run leaves a sum from +0 as it is
#pragma unroll
  for (int r = 0; r < kQuarter; ++r) acc = __fadd_rn(acc, run[r]);
  part[((long long)tile * kLane + tid) * kQuarters + q] = acc;
}

// E over items (tile, q) = item / 4, item % 4, item = blockIdx.x + k *
// gridDim.x < n_items: part[(T*128 + j)*4 + q] = the sum over the quarter's
// residues a = 32q .. 32q + 31, in order from +0, of the run of slot j in
// row T*128 + a: its lanes (hlo, hhi] (hhi -1: no run; the runs of one
// residue are disjoint and nonempty) added in lane order from +0, lane l
// holding hvals[T*128 + a, l] * x[hwidx[T]*16384 + hpidx[T*128 + a, l]*128 +
// a] (x zero past n_x). Two stage buffers: the next item's copies are in
// flight while this one's sums are taken. hvals, hpidx, hlo and hhi are
// 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kHeavyThreads)
routed_heavy_kernel(const T* __restrict__ hvals, const int8_t* __restrict__ hpidx,
                    const int32_t* __restrict__ hwidx, const int8_t* __restrict__ hlo,
                    const int8_t* __restrict__ hhi, int n_items, const float* __restrict__ x,
                    long long n_x, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  HeavyStageBuf* stage = reinterpret_cast<HeavyStageBuf*>(smem);
  unsigned char* fl_s = smem + 2 * sizeof(HeavyStageBuf);  // lane flags: 1 start, 2 end
  for (int c = threadIdx.x; c < kQuarter * kPxPitch / 16; c += kHeavyThreads)
    reinterpret_cast<uint4*>(fl_s)[c] = make_uint4(0, 0, 0, 0);
  int item = blockIdx.x, next = item + gridDim.x;
  int hw_next = next < n_items ? __ldg(hwidx + next / kQuarters) : 0;
  if (item < n_items)
    heavy_issue<T>(stage[0], hvals, hpidx, hlo, hhi, x, n_x, item / kQuarters, item % kQuarters,
                   __ldg(hwidx + item / kQuarters));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; item < n_items; ++k) {
    if (next < n_items)
      heavy_issue<T>(stage[(k + 1) & 1], hvals, hpidx, hlo, hhi, x, n_x, next / kQuarters,
                     next % kQuarters, hw_next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int after = next + gridDim.x;
    hw_next = after < n_items ? __ldg(hwidx + after / kQuarters) : 0;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this item's copies
    __syncthreads();
    heavy_sums<T>(stage[k & 1], fl_s, item / kQuarters, item % kQuarters, part);
    __syncthreads();  // its buffer is free, the flags zero
    item = next;
    next = after;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

template <typename T>
cudaError_t gather_launch_t(const T* vals, const int8_t* pidx, const int32_t* widx,
                            const int8_t* w1, int n_real, int n_tiles, const float* x,
                            long long n_x, float* out, cudaStream_t st) {
  auto kernel = routed_gather_kernel<T>;
  // above 48 KB of dynamic shared memory; the attribute is per device, so
  // it is set on every launch (cheap, allowed in graph capture)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGatherSmem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)n_tiles * (kLane / kBand / kGatherBands), kThreads, kGatherSmem, st>>>(
      vals, pidx, widx, w1, n_real, x, n_x, out);
  return cudaGetLastError();
}

// a CTA of kGatherSmem bytes per kGatherBands bands of a tile
int gather_launch(int vals_bf16, const void* vals, const int8_t* pidx, const int32_t* widx,
                  const int8_t* w1, int n_real, int n_tiles, const float* x, long long n_x,
                  float* out, cudaStream_t st) {
  static_assert((kLane / kBand) % kGatherBands == 0, "a CTA takes whole bands of one tile");
  return (int)(vals_bf16 ? gather_launch_t((const __nv_bfloat16*)vals, pidx, widx, w1, n_real,
                                           n_tiles, x, n_x, out, st)
                         : gather_launch_t((const float*)vals, pidx, widx, w1, n_real, n_tiles,
                                           x, n_x, out, st));
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

// part: n_h * ceil(n_pad / kHChunk) f32 of scratch; ticket: zero, and left
// zero
int hdense_launch(const void* H, int n_h, long long n_pad, const float* x, long long n_x,
                  const int32_t* target, float* out, float* part, unsigned* ticket,
                  cudaStream_t st) {
  if (n_h < 1 || n_h > kHRows * kCloseRows) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_cta = (int)((n_pad + kHChunk - 1) / kHChunk);
  // rows per CTA: all (up to kHRows), halved while the CTAs would be
  // fewer than half the SMs (x is read once per row group)
  int rows = min(n_h, kHRows);
  while (rows > 1 && 2LL * n_cta * ((n_h + rows - 1) / rows) < sms) rows = (rows + 1) / 2;
  const dim3 grid((unsigned)n_cta, (unsigned)((n_h + rows - 1) / rows));
  routed_hdense_kernel<<<grid, kThreads, 0, st>>>((const __nv_bfloat16*)H, n_h, n_pad, rows, x,
                                                  n_x, target, out, part, ticket);
  return (int)cudaGetLastError();
}

// part: n_tiles * 128 * kQuarters f32 of scratch, 16-byte aligned
int heavy_launch(int vals_bf16, const void* hvals, const int8_t* hpidx, const int32_t* hwidx,
                 const int8_t* hlo, const int8_t* hhi, int n_tiles, const int32_t* slot_ptr,
                 const int32_t* slot_idx, const int32_t* rows, int n_h, const float* x,
                 long long n_x, float* part, float* out, cudaStream_t st) {
  // persistent CTAs, kHeavyCtasPerSm per SM, each walking items in turn
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_items = n_tiles * kQuarters;
  const unsigned grid = (unsigned)min(n_items, kHeavyCtasPerSm * sms);
  // above 48 KB of dynamic shared memory; the attribute is per device, so
  // it is set on every launch (cheap, allowed in graph capture)
  if (vals_bf16) {
    e = cudaFuncSetAttribute(routed_heavy_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHeavySmem);
    if (e == cudaSuccess)
      routed_heavy_kernel<__nv_bfloat16><<<grid, kHeavyThreads, kHeavySmem, st>>>(
          (const __nv_bfloat16*)hvals, hpidx, hwidx, hlo, hhi, n_items, x, n_x, part);
  } else {
    e = cudaFuncSetAttribute(routed_heavy_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHeavySmem);
    if (e == cudaSuccess)
      routed_heavy_kernel<float><<<grid, kHeavyThreads, kHeavySmem, st>>>(
          (const float*)hvals, hpidx, hwidx, hlo, hhi, n_items, x, n_x, part);
  }
  if (e != cudaSuccess) return (int)e;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  routed_row_sums_kernel<<<(unsigned)((n_h + kRowWarps - 1) / kRowWarps), kRowWarps * 32, 0,
                           st>>>(part, slot_ptr, slot_idx, rows, n_h, out);
  return (int)cudaGetLastError();
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
constexpr int kOpWords[] = {0, 9, 5, 8, 8, 3, 14, 9};  // by op: the op and its operands

}  // namespace

extern "C" {

// Runs the len-entry program prog (ops with their operands, see
// routed_cuda.py::_op) on the stream: A (gather), B (permute), C (perm
// reduce), D (dense heavy rows), E (pooled heavy tiles), the small kernel
// and memsets. counts[0..5] (host memory) gains one for each op of A, B, C,
// D, E and the small kernel that was enqueued without error (E: the
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
      case kOpHDense:  // H n_h n_pad target out part ticket
        rc = hdense_launch(P(i + 1), (int)prog[i + 2], prog[i + 3], x, n_x,
                           (const int32_t*)P(i + 4), (float*)P(i + 5), (float*)P(i + 6),
                           (unsigned*)P(i + 7), st);
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
