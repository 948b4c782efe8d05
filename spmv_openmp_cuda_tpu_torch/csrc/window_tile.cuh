// Shared pieces of the window kernels (csrc/window_spmv.cu: f32/bf16 values;
// csrc/df_spmv.cu: double-float). See window_spmv.cu for the design.
//
// Dynamic shared memory of one CTA, in this order (window_smem_bytes):
//   x window  win_rows * 128 elements of X (f32, or f64 split in place into
//             (hi, lo) f32 pairs): x chunks x_base .. x_base + win_rows,
//             zero outside [0, n);
//   row tile  g_pad * 128 accumulators (f32, or an (hi, lo) float2), lane l
//             of row r at r*128 + (l%4)*32 + l/4, so that the 32 threads of
//             a warp (lanes 4t .. 4t+3) hit 32 banks for each l%4;
//   Q chunk   the Q map of 64 slot rows, qs[res*kQPitch + kk];
//   ring      `depth` stages of one slot row per thread: its 4 lanes' values
//             (vals_bytes), sidx and gid (4 + 4 bytes), filled by cp.async;
//             each warp loads its mod-8 rows, then one overflow row in eight
//             of the CTA's, which the CTA reads from the loader's stage;
//   mbarrier  of the x window's bulk copy.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wtile {

constexpr int kLane = 128;
constexpr int kThreads = 256;  // eight warps: warp j takes the slot rows k % 8 == j
constexpr int kWarps = kThreads / 32;
constexpr int kQRows = 64;     // slot rows per staged Q chunk
constexpr int kQPitch = 68;    // bytes per staged residue (17 words: res*17 spreads banks)
constexpr int kQBytes = kLane * kQPitch;
constexpr int kQVecs = kLane * kQRows / 16 / kThreads;  // 16-byte Q vectors per thread
constexpr int kMaxCluster = 8;  // portable cluster size

__host__ __device__ __forceinline__ int g_pad_of(int g) { return ((g + 7) / 8) * 8; }

// bytes of dynamic shared memory: x_bytes and acc_bytes 4 (f32) or 8 (df),
// vals_bytes per thread and slot row (16 f32, 8 bf16, 32 df)
__host__ __device__ __forceinline__ size_t window_smem_bytes(int g, int win_rows, int x_bytes,
                                                            int acc_bytes, int vals_bytes,
                                                            int depth) {
  return (size_t)win_rows * kLane * x_bytes + (size_t)g_pad_of(g) * kLane * acc_bytes +
         (size_t)kQBytes + (size_t)depth * kThreads * (vals_bytes + 8) + 16;
}

// x chunk held by window row 0 of block blk: 8*floor(blk*g/8) - wr
// (standard, xmode 0), 0 (xdirect, 1), (blk - blk%bps)*g - wr (shared_w, 2)
__device__ __forceinline__ long long x_base_of(int xmode, int blk, int g, int wr, int bps) {
  return xmode == 1 ? 0LL
         : xmode == 2 ? (long long)(blk - blk % bps) * g - wr
                      : 8LL * (((long long)blk * g) / 8) - wr;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies of one thread (Ampere's cp.async): no registers
// hold the bytes in flight; a thread reads back only what it copied

// 16-byte copies bypass L1 (.cg: the slot streams are read once); the
// smaller ones go through it (.ca, the only form for 4 and 8 bytes)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(reinterpret_cast<uint64_t>(src))
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(reinterpret_cast<uint64_t>(src)), "n"(kBytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage x[x0 .. x0 + elems) into xs (zero outside [x_lo, n_x)): one bulk
// asynchronous copy (Hopper's 1-D TMA) of the 16-byte-aligned in-range
// part, completing on the mbarrier bar; the threads zero the part outside x
// and load the in-range tail the copy leaves (< 16 bytes). x_lo <= 0 is the
// first element readable before x[0]: 0 for a whole x, -wr*128 for a row
// shard whose left halo sits before its own first row (the multi-device
// window path, parallel/sharded.py). x, x0 * sizeof(X) and x_lo * sizeof(X)
// are 16-byte aligned (x0 and x_lo are multiples of 128). Ends with the
// window visible to every thread of the CTA.
template <typename X>
__device__ __forceinline__ void stage_x(X* xs, const X* __restrict__ x, long long x_lo,
                                        long long n_x, long long x0, int elems, uint64_t* bar) {
  const int tid = threadIdx.x;
  const long long a = min(max(x_lo - x0, 0LL), (long long)elems);  // elements before x[x_lo]
  long long cnt = min(n_x, x0 + elems) - (x0 + a);                  // elements inside x
  if (cnt < 0) cnt = 0;
  const int bulk = (int)(cnt * (long long)sizeof(X) / 16 * 16 / (long long)sizeof(X));
  const uint32_t b = smem_addr(bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (bulk > 0) {
      const uint32_t bytes = (uint32_t)(bulk * sizeof(X));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(xs + a)),
          "l"(reinterpret_cast<uint64_t>(x + x0 + a)), "r"(bytes), "r"(b)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
    }
  }
  for (int e = tid; e < (int)a; e += kThreads) xs[e] = X(0);
  for (int e = (int)a + bulk + tid; e < (int)(a + cnt); e += kThreads) xs[e] = x[x0 + e];
  for (int e = (int)(a + cnt) + tid; e < elems; e += kThreads) xs[e] = X(0);
  __syncthreads();
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" ::"r"(b),
      "r"(0)
      : "memory");
}

// The Q map of slot rows [c0, c0 + kQRows) of block blk (c0 % kQRows == 0,
// so the chunk lies in one 128-row tile; rsrc is 16-byte aligned): load_q
// reads this thread's 16-byte vectors into registers, store_q writes them
// as qs[res*kQPitch + (k - c0)]. A chunk's loads start before the
// previous chunk's slot rows run; the caller brackets store_q with
// barriers.
__device__ __forceinline__ void load_q(uint4 (&v)[kQVecs], const int8_t* __restrict__ rsrc,
                                       int blk, int n_kt, int c0) {
  constexpr int kVecs = kQRows / 16;  // per residue
  const int8_t* qt = rsrc + ((long long)blk * n_kt + c0 / kLane) * kLane * kLane + c0 % kLane;
#pragma unroll
  for (int j = 0; j < kQVecs; ++j) {
    const int c = threadIdx.x + j * kThreads;
    v[j] = __ldg(reinterpret_cast<const uint4*>(qt + (c / kVecs) * kLane) + c % kVecs);
  }
}

__device__ __forceinline__ void store_q(int8_t* qs, const uint4 (&v)[kQVecs]) {
  constexpr int kVecs = kQRows / 16;
#pragma unroll
  for (int j = 0; j < kQVecs; ++j) {
    const int c = threadIdx.x + j * kThreads;
    uint32_t* d = reinterpret_cast<uint32_t*>(qs + (c / kVecs) * kQPitch) + 4 * (c % kVecs);
    d[0] = v[j].x;
    d[1] = v[j].y;
    d[2] = v[j].z;
    d[3] = v[j].w;
  }
}

// The slot rows of a block split over the CTAs of a cluster by their cost
// to a warp, in eighths of a slot row: a mod-8 row (k < k_c) costs 1 (a
// warp takes one row in eight), an overflow row kOverflowCost (a warp takes
// a quarter of its lanes). CTA rank takes [rank_start(rank),
// rank_start(rank + 1)), the last one up to k_pad; step >= the block's cost
// over the cluster size (ops/window_cuda.py::launch_plan).
constexpr int kOverflowCost = 4;

__host__ __device__ __forceinline__ int rank_start(int rank, int step, int k_c, int k_pad) {
  const long long u = (long long)rank * step;
  long long k = u <= k_c ? u : k_c + (u - k_c) / kOverflowCost;
  k = (k + 7) / 8 * 8;  // a multiple of 8: warp w's mod-8 rows are k0 + w + 8i
  return (int)(k < k_pad ? k : k_pad);
}

// The slot rows one warp loads in a CTA's range [k0, k1), in order: j < n8
// its mod-8 rows k0 + w + 8j (below m8 = min(k1, k_c)), then j - n8 = m its
// share of the overflow rows, ov0 + w + 8m (ov0 = max(k0, k_c)), which it
// loads for every warp of the CTA.
struct WarpRows {
  int k0, m8, ov0, w, n8, total;
  __device__ __forceinline__ WarpRows(int k0_, int k1, int k_c, int w_)
      : k0(k0_), m8(min(k1, k_c)), ov0(max(k0_, k_c)), w(w_) {
    n8 = mod8_rows(w);
    total = n8 + (k1 > ov0 + w ? (k1 - ov0 - w + 7) / 8 : 0);
  }
  // the mod-8 rows of warp v
  __device__ __forceinline__ int mod8_rows(int v) const {
    return m8 > k0 + v ? (m8 - k0 - v + 7) / 8 : 0;
  }
  __device__ __forceinline__ int row(int j) const {
    return j < n8 ? k0 + w + 8 * j : ov0 + w + 8 * (j - n8);
  }
  // the first ring slot of overflow row k: the loader warp v = (k - ov0) %
  // 8 holds its 128 lanes in slots base .. base + 31 (4 lanes each)
  template <int D>
  __device__ __forceinline__ int overflow_base(int k) const {
    const int v = (k - ov0) % 8;
    return ((mod8_rows(v) + (k - ov0) / 8) % D) * kThreads + v * 32;
  }
};

}  // namespace wtile
