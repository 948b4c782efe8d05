// Lane-gather SpMV kernel for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel spmv_openmp_cuda_tpu/formats/lanes.py::
// lanes_small_spmv (pallas_call at :170). There each (128, 128) slot tile of
// window w gathers windowT[w][a, pidx] (x viewed as 128 residues x 128
// panels, so the gather stays inside one 128-lane row, the only gather the
// TPU does fast), multiplies by vals and adds the products into y2d
// (G, 128) by G masked sublane sums, G = ceil(m/128) <= 64.
//
// On the GPU no such view is needed: slot (s, l) of a tile of window w
// stands for column c = w*16384 + pidx[s, l]*128 + (s % 128) and row
// gid[s, l]*128 + l, so the kernel reads x[c] directly (0 for c outside
// [0, n): the empty slots of the last window point there, and the TPU reads
// the zero padding of x at those columns).
//
// What bounds it: 12 B of slot arrays (value, panel, group) per slot for 2
// flops, plus x and y: 1-5 MB on the small matrices it serves, 0.3-1.6 us
// at 3.35 TB/s, and they stay in the 50 MB L2 between calls. So the time is
// latency: one launch, and the chain of dependent loads (slot arrays, then
// x, then the add) each warp walks. The design:
//   - Lanes are independent: a slot of lane l only adds into a row of lane
//     l. So the 128 lanes split into kBands bands of 32, with no reduction
//     between bands, and a warp's load of one slot row's band is one
//     128-byte line per array.
//   - Each band's slot rows split over the kWarps warps of a CTA and over
//     the `csize` CTAs of a thread-block cluster (1, 2, 4 or 8; the launch
//     plan is ops/lanes_cuda.py::launch_plan): warp wg = rank*kWarps + w
//     takes the batches of kBatch slot rows [wg*step, (wg+1)*step). So
//     delaunay_n12_like's 896 slot rows run on 4 bands x 8 CTAs x 8 warps,
//     not 28 CTAs.
//   - Each warp sums into a private (G, 32) f32 tile in shared memory: lane
//     t owns column t, so the adds have one writer per cell, no atomics and
//     no bank conflicts. A warp keeps two batches of 16 slot rows' loads
//     in flight (the next batch's before this batch's x gathers), with
//     tile_win read once per batch (a batch never crosses a 128-row tile).
//   - The close is fixed-order, in one launch, with no partial tiles in
//     global memory: the CTA adds its warps' tiles in warp order and sends
//     each row group g of the sum to the inbox of CTA g % csize, in its
//     slot for the sender's rank, through distributed shared memory; after
//     a cluster barrier each CTA adds its inbox's slots in rank order and
//     writes its row groups to y. The barrier's first phase (every CTA has
//     started) is split around the main loop, and no CTA reads another's
//     shared memory after the second, so none waits at its exit. So a rerun
//     gives the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kLane = 128;
constexpr int kBand = 32;                   // lanes per band: one warp's width
constexpr int kBands = kLane / kBand;
constexpr int kWarps = 8;                   // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 16;                  // slot rows per batch (a 128-row tile holds 8)
constexpr int kMaxGroups = 64;              // G: row groups of 128 rows
constexpr int kMaxCluster = 8;              // portable cluster size
constexpr long long kWindow = 128LL * 128;  // x values per window

struct Batch {
  float v[kBatch];
  int p[kBatch], g[kBatch];
  long long wbase;  // window base column + the batch's first residue
};

__device__ __forceinline__ void load_batch(Batch& b, const float* __restrict__ vals,
                                           const int* __restrict__ pidx,
                                           const int* __restrict__ gid,
                                           const int* __restrict__ tile_win, int q, int l) {
  const int s0 = q * kBatch;
  b.wbase = (long long)__ldg(tile_win + s0 / kLane) * kWindow + s0 % kLane;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const long long i = (long long)(s0 + u) * kLane + l;
    b.v[u] = __ldg(vals + i);
    b.p[u] = __ldg(pidx + i);
    b.g[u] = __ldg(gid + i);
  }
}

// y[r] for r < m: sum over slots (s, l) with gid*128 + l == r of vals * x[c].
__global__ void __launch_bounds__(kThreads)
lanes_kernel(const float* __restrict__ vals, const int* __restrict__ pidx,
             const int* __restrict__ gid, const int* __restrict__ tile_win, int n_rows,
             int n_groups, int step, const float* __restrict__ x, long long n_x, long long m,
             float* __restrict__ y, int csize) {
  // kWarps tiles of (n_groups, kBand), then the inbox: csize slots of
  // (own, kBand), own = the row groups g % csize == rank
  extern __shared__ float tiles[];
  const int t = threadIdx.x % 32, w = threadIdx.x / 32;
  const int band = blockIdx.x / csize, rank = blockIdx.x % csize;
  const int l = band * kBand + t;
  const int cells = n_groups * kBand;
  float* acc = tiles + w * cells;
  for (int g = 0; g < n_groups; ++g) acc[g * kBand + t] = 0.f;
  // the first phase of the cluster barrier: every CTA of the cluster has
  // started (its shared memory exists) once the wait before the close
  // returns, which the main loop hides
  if (csize > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int wg = rank * kWarps + w;
  const int q0 = wg * step;
  const int q1 = min(q0 + step, n_rows / kBatch);
  Batch cur, nxt;
  if (q0 < q1) load_batch(cur, vals, pidx, gid, tile_win, q0, l);
  for (int q = q0; q < q1; ++q) {
    float xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long c = cur.wbase + (long long)cur.p[u] * kLane + u;
      xv[u] = (c >= 0 && c < n_x) ? __ldg(x + c) : 0.f;
    }
    if (q + 1 < q1) load_batch(nxt, vals, pidx, gid, tile_win, q + 1, l);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if ((unsigned)cur.g[u] < (unsigned)n_groups) acc[cur.g[u] * kBand + t] += cur.v[u] * xv[u];
    cur = nxt;
  }
  __syncthreads();

  // the CTA's tile (its warps' tiles added in warp order), each row group
  // g sent to slot `rank` of CTA g % csize's inbox
  cg::cluster_group cluster = cg::this_cluster();
  if (csize > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int own = (n_groups + csize - 1) / csize;
  float* inbox = tiles + kWarps * cells;
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    float s = tiles[c];
    for (int v = 1; v < kWarps; ++v) s += tiles[v * cells + c];
    const int g = c / kBand;
    float* box = csize > 1 ? cluster.map_shared_rank(inbox, g % csize) : inbox;
    box[(rank * own + g / csize) * kBand + c % kBand] = s;
  }
  if (csize > 1)
    cluster.sync();  // the second phase: every inbox is full
  else
    __syncthreads();
  // row groups g % csize == rank: the inbox's slots added in rank order
  for (int g = rank + csize * w; g < n_groups; g += csize * kWarps) {
    const int j = (g / csize) * kBand + t;
    float s = inbox[j];
    for (int r = 1; r < csize; ++r) s += inbox[r * own * kBand + j];
    const long long row = (long long)g * kLane + l;
    if (row < m) y[row] = s;
  }
}

// the warps' tiles and the inbox
size_t lanes_smem(int n_groups, int csize) {
  return ((size_t)kWarps * n_groups + (size_t)csize * ((n_groups + csize - 1) / csize)) * kBand *
         sizeof(float);
}

}  // namespace

extern "C" {

// y (f32, length m) = the lane-gather product over n_rows slot rows (a
// multiple of 128) of n_groups row groups: vals f32, pidx, gid int32 (n_rows,
// 128), tile_win int32 (n_rows/128). The launch plan
// (ops/lanes_cuda.py::launch_plan): csize CTAs per band (1, or a cluster of
// 2, 4 or 8), each warp taking `step` batches of kBatch slot rows
// (csize*kWarps*step*kBatch >= n_rows), and smem bytes of dynamic shared memory (lanes_smem). Writes
// every row of y; returns cudaErrorInvalidValue for a plan it does not
// take, else the launch's error, or 0.
int lanes_launch(const float* vals, const int* pidx, const int* gid, const int* tile_win,
                 int n_rows, int n_groups, const float* x, long long n_x, long long m,
                 float* y, int csize, int step, int smem, void* stream) {
  const bool csize_ok = csize == 1 || csize == 2 || csize == 4 || csize == kMaxCluster;
  if (!csize_ok || n_rows <= 0 || n_rows % kLane || n_groups <= 0 || n_groups > kMaxGroups ||
      (long long)n_groups * kLane < m || step <= 0 ||
      (long long)csize * kWarps * step * kBatch < n_rows ||
      (size_t)smem != lanes_smem(n_groups, csize))
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  if (smem > 48 * 1024) {
    // the attribute is per device, so it is set on every such launch
    // (cheap, and allowed during graph capture)
    const cudaError_t e = cudaFuncSetAttribute(
        lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(kBands * csize));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lanes_kernel, vals, pidx, gid, tile_win, n_rows,
                                           n_groups, step, x, n_x, m, y, csize);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

const char* lanes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
