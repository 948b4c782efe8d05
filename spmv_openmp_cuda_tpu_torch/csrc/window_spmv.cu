// Windowed local-gather SpMV kernels for Hopper (sm_90a), bound through a
// plain C interface.
//
// Replaces the TPU kernels of spmv_openmp_cuda_tpu/formats/window.py:
//   window_blocks_kernel <- window_kernel_call (pallas_call at :1062; its
//                           body is _gather_reduce_block, :834-951), the
//                           standard and shared_w x staging;
//   window_single_kernel <- _window_single_call (pallas_call at :1125), the
//                           single-block layout that addresses x directly
//                           (xdirect).
// Both compute, for every slot (block i, slot row k < k_pad, lane l):
//   Q   = rsrc[(i*n_kt + k/128)*128 + sidx[i,k,l], k%128]   (window row)
//   col = (x_base(i) + Q)*128 + sidx[i,k,l]                  (x read as 0
//                                                             outside [x_lo, n))
//   r   = k < k_c ? 8*gid[i,k,l] + k%8 : gid[i,k,l]          (mod-8 fold)
//   y[(i*g + r)*128 + l] += vals[i,k,l] * x[col]             for r < g
// with x_base(i) = 8*floor(i*g/8) - wr (standard), (i - i%bps)*g - wr
// (shared_w) or 0 (xdirect): the chunk of x that window row 0 holds in the
// TPU kernel's staging. x is never rounded: only vals may be bf16.
//
// What bounds it: bytes. 2 flops per slot against vals (4 or 2 B) + sidx +
// gid (1 + 1 B) per slot, the Q map (1 B per slot row and residue), x once
// and y once: thermal2_like moves ~100 MB for 17 MFLOP.
//
// The design (csrc/window_tile.cuh holds the staging):
//   - A block per CTA, or per thread-block cluster. One CTA of 256 threads
//     computes a whole block of the TPU's grid and writes its g rows of y:
//     no partial tiles in global memory and no second launch. Where the
//     blocks alone cannot fill the card (FEM_3D_thermal2's 29, delaunay's
//     one), the block's slot rows are split over the `cluster` CTAs of a
//     thread-block cluster (2, 4 or 8; the launch plan is
//     ops/window_cuda.py::launch_plan), in ranges of equal cost to a warp
//     (window_tile.cuh::rank_start: an overflow row costs a warp four times
//     what a mod-8 row does, since every warp reads it); each CTA sums its rows
//     into its own shared-memory tile, and after a cluster barrier CTA
//     `rank` adds the tiles of rows r = rank, rank + cluster, ... in rank
//     order through distributed shared memory and writes them to y.
//   - The mod-8 fold is the unit of parallelism. A slot row k < k_c adds
//     only into rows r = 8*gid + k%8, so warp j takes the slot rows k % 8 ==
//     j and adds into the rows r % 8 == j of the one (g_pad, 128) tile: each
//     cell has one writer, in slot-row order, and no atomics. The overflow
//     rows k >= k_c (any r) come after a barrier: each warp loads one in
//     eight of them, and warp j reads lanes 4t + j%4 of every one in shared
//     memory and adds the slots whose r % 2 == j/4, again one writer per
//     cell. So a rerun on the same x gives the same y bit for bit.
//   - The x window is staged in shared memory once per CTA with one bulk
//     asynchronous copy (cp.async.bulk + mbarrier), as the TPU kernel stages
//     it into VMEM: win_rows = 8*nspecs rows (8*ns_tot for shared_w, the x
//     chunks for xdirect) of 128 values, <= 64 KB. ops/window_cuda.py checks
//     once per layout that every Q lies inside the staged rows.
//   - The Q map is staged per 64 slot rows (kQRows), residue-major with a
//     68-byte pitch, so that a warp's lookups at one slot row spread banks;
//     the next chunk's 16-byte loads are in flight while a chunk runs.
//   - Each thread takes 4 lanes of a slot row: vals 16 bytes (f32) or 8
//     (bf16), sidx and gid 4 bytes each. The bytes reach shared memory by
//     cp.async into a ring of kDepth (8) stages per thread, so that 8 slot
//     rows per thread are in flight without holding registers (6 per row
//     and thread, were they loaded into registers). A thread reads back only
//     its own copies of its mod-8 rows, so those need no barrier.
#include <cuda_bf16.h>

#include "window_tile.cuh"

namespace {

using namespace wtile;
namespace cg = cooperative_groups;

struct Vals4 {
  float v[4];
};

struct Args {
  const void* vals;
  const int8_t* sidx;
  const int8_t* gid;
  const int8_t* rsrc;
  const float* x;
  float* y;
  long long x_lo, n_x, m;
  int g, k_pad, k_c, n_kt, wr, bps, xmode, step, win_rows;
};

constexpr int kDepth = 8;  // slot rows a thread has in flight (cp.async ring stages)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ Vals4 ring_vals(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ Vals4 ring_vals(const __nv_bfloat16* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  return {{__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)}};
}

// One mod-8 slot row k (Q chunk c0) of this thread's 4 lanes, from its ring
// stage: each lane's product added into row 8*gid + w of the tile, which
// warp w owns.
template <typename T>
__device__ __forceinline__ void slot_row(const T* rv, char4 sc, char4 gc, int k, int c0,
                                         int g_pad, const float* xs, float* tile,
                                         const int8_t* qs) {
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const Vals4 v = ring_vals(rv);
  const int8_t sv[4] = {sc.x, sc.y, sc.z, sc.w};
  const int8_t gv[4] = {gc.x, gc.y, gc.z, gc.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 8 * (int)gv[i] + w;
    if (r >= g_pad) continue;
    const int res = sv[i];
    // Q < win_rows: ops/window_cuda.py checks it once per layout
    const int q = qs[res * kQPitch + (k - c0)];
    tile[r * kLane + i * 32 + t] += v.v[i] * xs[q * kLane + res];
  }
}

// One overflow slot row k (Q chunk c0), its 128 lanes from the loader's ring
// slots (vals from rv, sidx and gid bytes from rs and rg): warp w takes lane
// 4t + w%4 and adds it into row gid of the tile if gid % 2 == w/4, so each
// cell has one writer and no warp scans more than a quarter of the lanes.
template <typename T>
__device__ __forceinline__ void overflow_lane(const T* rv, const int8_t* rs, const int8_t* rg,
                                              int k, int c0, int g_pad, const float* xs,
                                              float* tile, const int8_t* qs) {
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5, i = w & 3;
  const int e = 4 * t + i;
  const int r = rg[e];
  if ((r & 1) != (w >> 2) || r >= g_pad) return;
  const int res = rs[e];
  const int q = qs[res * kQPitch + (k - c0)];
  tile[r * kLane + i * 32 + t] += to_f32(rv[e]) * xs[q * kLane + res];
}

// One CTA: block blk, CTA `rank` of its cluster (window_tile.cuh::rank_start).
template <typename T>
__device__ __forceinline__ void window_body(const Args& a, int blk, int rank, int csize) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int g_pad = g_pad_of(a.g);
  float* xs = reinterpret_cast<float*>(smem);
  float* tile = xs + a.win_rows * kLane;
  int8_t* qs = reinterpret_cast<int8_t*>(tile + g_pad * kLane);
  T* ringv = reinterpret_cast<T*>(qs + kQBytes);  // [kDepth][kThreads][4]
  char4* rings = reinterpret_cast<char4*>(ringv + kDepth * kThreads * 4);
  char4* ringg = rings + kDepth * kThreads;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ringg + kDepth * kThreads);
  const int tid = threadIdx.x, t = tid & 31, w = tid >> 5;
  const long long x_base = x_base_of(a.xmode, blk, a.g, a.wr, a.bps);
  const int k0 = rank_start(rank, a.step, a.k_c, a.k_pad);
  const int k1 = rank == csize - 1 ? a.k_pad : rank_start(rank + 1, a.step, a.k_c, a.k_pad);
  const WarpRows rows(k0, k1, a.k_c, w);
  const long long base = (long long)blk * a.k_pad * kLane + 4 * t;
  const T* vals = static_cast<const T*>(a.vals);

  // the ring: row j of this warp's sequence (WarpRows) into stage j %
  // kDepth, one commit group per row (empty past the last), so that
  // wait<kDepth - 1> always means "row j has landed"
  int queued = 0;
  auto enqueue = [&]() {
    if (queued < rows.total) {
      const long long off = base + (long long)rows.row(queued) * kLane;
      const int slot = (queued % kDepth) * kThreads + tid;
      cp_async<4 * sizeof(T)>(ringv + 4 * slot, vals + off);
      cp_async<4>(rings + slot, a.sidx + off);
      cp_async<4>(ringg + slot, a.gid + off);
    }
    cp_async_commit();
    ++queued;
  };
  for (int j = 0; j < kDepth; ++j) enqueue();
  // the Q chunk in qs (none yet), and the one whose loads are in qv
  int q_c0 = -1, next_c0 = k0 / kQRows * kQRows;
  uint4 qv[kQVecs];
  if (next_c0 < k1) load_q(qv, a.rsrc, blk, a.n_kt, next_c0);
  auto stage_next_q = [&]() {  // called by every thread: barriers inside
    __syncthreads();           // the previous chunk's Q and tile updates are done
    store_q(qs, qv);
    q_c0 = next_c0;
    next_c0 += kQRows;
    if (next_c0 < k1) load_q(qv, a.rsrc, blk, a.n_kt, next_c0);
    __syncthreads();
  };
  for (int e = tid; e < g_pad * kLane; e += kThreads) tile[e] = 0.f;
  stage_x(xs, a.x, a.x_lo, a.n_x, x_base * kLane, a.win_rows * kLane, bar);

  // the mod-8 rows, chunk by chunk: warp w's own rows, one writer per cell
  int j = 0;
  while (next_c0 < rows.m8) {
    stage_next_q();
    for (; j < rows.n8 && rows.row(j) < q_c0 + kQRows; ++j) {
      cp_async_wait<kDepth - 1>();
      const int slot = (j % kDepth) * kThreads + tid;
      slot_row<T>(ringv + 4 * slot, rings[slot], ringg[slot], rows.row(j), q_c0, g_pad, xs,
                  tile, qs);
      enqueue();
    }
  }
  // the overflow rows, 8*kDepth at a time: each warp's share of them is
  // already in its ring (queued behind its mod-8 rows); after a barrier
  // every warp reads its quarter of the lanes of every row from the
  // loader's stage, in row order
  for (int s0 = rows.ov0; s0 < k1; s0 += 8 * kDepth) {
    const int s1 = min(s0 + 8 * kDepth, k1);
    cp_async_wait<0>();
    __syncthreads();  // every warp's rows have landed; the mod-8 adds are done
    for (int k = s0; k < s1; ++k) {
      if (q_c0 < 0 || k >= q_c0 + kQRows) stage_next_q();
      const int b = rows.overflow_base<kDepth>(k);
      overflow_lane<T>(ringv + 4 * b, reinterpret_cast<const int8_t*>(rings + b),
                       reinterpret_cast<const int8_t*>(ringg + b), k, q_c0, g_pad, xs, tile, qs);
    }
    __syncthreads();  // the stages are read: refill them
    for (int i = 0; i < kDepth; ++i) enqueue();
  }
  cp_async_wait<0>();
  __syncthreads();

  // y rows r of this CTA: all g (no cluster), or r % csize == rank, each the
  // cluster's tiles added in rank order
  const long long row0 = (long long)blk * a.g * kLane;
  cg::cluster_group cluster = cg::this_cluster();
  if (csize > 1) cluster.sync();
  for (int r = rank + csize * w; r < a.g; r += csize * kWarps) {
    float v[4];
    const float* t0 = csize > 1 ? cluster.map_shared_rank(tile, 0) : tile;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = t0[r * kLane + i * 32 + t];
    for (int s = 1; s < csize; ++s) {
      const float* ts = cluster.map_shared_rank(tile, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += ts[r * kLane + i * 32 + t];
    }
    const long long row = row0 + (long long)r * kLane + 4 * t;
    if (row + 3 < a.m) {
      *reinterpret_cast<float4*>(a.y + row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (row + i < a.m) a.y[row + i] = v[i];
    }
  }
  if (csize > 1) cluster.sync();  // no CTA leaves while its tile is read
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) window_blocks_kernel(Args a, int csize) {
  window_body<T>(a, blockIdx.x / csize, blockIdx.x % csize, csize);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) window_single_kernel(Args a, int csize) {
  window_body<T>(a, 0, blockIdx.x % csize, csize);
}

template <typename T>
cudaError_t launch(const Args& a, int nblocks, int csize, size_t smem, cudaStream_t st) {
  void (*kernel)(Args, int) = a.xmode == 1 ? window_single_kernel<T> : window_blocks_kernel<T>;
  // above 48 KB of dynamic shared memory; the attribute is per device, so
  // it is set on every launch (cheap, allowed in graph capture)
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)nblocks * csize));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a, csize);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// y (f32, length m) = the window sums of nblocks blocks; vals f32
// (vals_bf16 == 0) or bf16; xmode 0 standard, 1 xdirect (one block), 2
// shared_w. x is read in [x_lo, n_x), zero outside: x_lo (<= 0, a multiple
// of 128) is 0 for a whole x and -wr*128 for a row shard whose left halo
// lies before x (parallel/sharded.py). The launch plan
// (ops/window_cuda.py::launch_plan): csize CTAs per block (1, or a cluster
// of 2, 4 or 8), CTA rank taking the slot rows
// from rank_start(rank, step, ...) (csize*step >= the block's cost),
// win_rows staged x rows (<= 128, and above every Q of rsrc), a ring of
// `depth` (8) stages, and smem bytes of dynamic shared memory
// (window_smem_bytes). Writes every row
// of y; returns cudaErrorInvalidValue for a plan it does not take, else the
// launch's error, or 0.
int window_launch(int vals_bf16, const void* vals, const int8_t* sidx, const int8_t* gid,
                  const int8_t* rsrc, int nblocks, int g, int k_pad, int k_c, int wr, int bps,
                  int xmode, const float* x, long long x_lo, long long n_x, long long m, float* y,
                  int csize, int step, int win_rows, int depth, int smem, void* stream) {
  const bool csize_ok = csize == 1 || csize == 2 || csize == 4 || csize == kMaxCluster;
  const int vals_bytes = vals_bf16 ? 8 : 16;
  const long long cost = k_c + (long long)kOverflowCost * (k_pad - k_c);
  if (!csize_ok || step <= 0 || (long long)csize * step < cost || win_rows < 1 ||
      win_rows > kLane || depth != kDepth ||
      (size_t)smem != window_smem_bytes(g, win_rows, 4, 4, vals_bytes, depth) ||
      (xmode == 1 && nblocks != 1) || x_lo > 0 || x_lo % kLane)
    return (int)cudaErrorInvalidValue;
  Args a{vals, sidx, gid, rsrc, x, y, x_lo, n_x, m, g, k_pad, k_c, (k_pad + kLane - 1) / kLane,
         wr, bps, xmode, step, win_rows};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = vals_bf16 ? launch<__nv_bfloat16>(a, nblocks, csize, smem, st)
                                  : launch<float>(a, nblocks, csize, smem, st);
  return (int)e;
}

const char* window_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
