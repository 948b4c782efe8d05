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
//     bf16 H, per-thread sums of 16 products, a shuffle tree per CTA and one
//     atomicAdd per CTA into the zeroed slot of the row's sum.
// x is read by global column behind a bounds test against n (no padded
// window stack is built). Products and data movement are exact, so A and B
// equal their plain versions bit for bit; C and D sum in another order.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage n_rows rows of a (., 128) int8 index array, row-contiguous 4-byte
// loads, into shared rows of pitch kPitch.
__device__ __forceinline__ void stage_index_rows(const int8_t* __restrict__ src, int n_rows,
                                                 unsigned char* dst) {
  for (int c = threadIdx.x; c < n_rows * (kLane / 4); c += blockDim.x) {
    const int r = c / (kLane / 4), wd = c % (kLane / 4);
    const uint32_t v = reinterpret_cast<const uint32_t*>(src + (long long)r * kLane)[wd];
    reinterpret_cast<uint32_t*>(dst + r * kPitch)[wd] = v;
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
  if (w1 != nullptr) stage_index_rows(w1 + base + (long long)band * kBand * kLane, kBand, ws);
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
template <bool kWhole>
__global__ void __launch_bounds__(kThreads)
routed_w_stage_kernel(const float* __restrict__ in, int in_rows, const int8_t* __restrict__ r,
                      const int8_t* __restrict__ w, const int8_t* __restrict__ ra, int t,
                      int sw, float* __restrict__ out, long long out_limit) {
  constexpr int L = kWhole ? kLane : kBand;
  constexpr int kBands = kLane / L;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);       // [128][L]
  unsigned char* ws = smem + kLane * L * sizeof(float);  // [L][kPitch]
  const int tq = blockIdx.x / kBands;
  const int lane0 = (blockIdx.x % kBands) * L;
  for (int c = threadIdx.x; c < kLane * L; c += kThreads) {
    const int s = c / L, lb = c % L;
    const int q = tq * kLane + s;
    const int p = sw ? (q % t) * kLane + q / t : q;
    float v = 0.f;
    if (p < in_rows) {
      const int l = lane0 + lb;
      const int src_l = r != nullptr ? (int)r[(long long)p * kLane + l] : l;
      v = in[(long long)p * kLane + src_l];
    }
    stage[s * L + lb] = v;
  }
  stage_index_rows(w + ((long long)tq * kLane + lane0) * kLane, L, ws);
  __syncthreads();
  for (int c = threadIdx.x; c < kLane * L; c += kThreads) {
    const int j = c / L, lb = c % L;
    const int q = tq * kLane + j;
    const int p = sw ? (q % t) * kLane + q / t : q;
    const long long o = (long long)p * kLane + lane0 + lb;
    const int m = (kWhole && ra != nullptr) ? (int)ra[o] : lb;
    const int src = (int)reinterpret_cast<const int8_t*>(ws)[m * kPitch + j];
    if (o < out_limit) out[o] = stage[src * L + m];
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

// D: out[target[k]] += sum over this CTA's columns c of f32(H[k, c]) * x[c]
// (x is zero past n_x; n_pad is a multiple of 128).
__global__ void __launch_bounds__(kThreads)
routed_hdense_kernel(const __nv_bfloat16* __restrict__ H, long long n_pad,
                     const float* __restrict__ x, long long n_x,
                     const int32_t* __restrict__ target, float* __restrict__ out) {
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
  __shared__ float part[kThreads / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) atomicAdd(out + target[k], v);
  }
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

int hdense_launch(const void* H, int n_h, long long n_pad, const float* x, long long n_x,
                  const int32_t* target, float* out, cudaStream_t st) {
  const dim3 grid((unsigned)((n_pad + kHChunk - 1) / kHChunk), (unsigned)n_h);
  routed_hdense_kernel<<<grid, kThreads, 0, st>>>((const __nv_bfloat16*)H, n_pad, x, n_x,
                                                  target, out);
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

enum Op { kOpGather = 1, kOpWStage = 2, kOpReduce = 3, kOpHDense = 4, kOpZero = 5 };
constexpr int kOpWords[] = {0, 9, 11, 11, 6, 3};  // by op: the op and its operands

}  // namespace

extern "C" {

// Runs the len-entry program prog (ops with their operands, see
// routed_cuda.py::_op) on the stream: A (gather), B (W stage), C (perm
// reduce), D (heavy rows) and memsets. counts[0..3] (host memory) gains one
// for each launch of A, B, C, D that was enqueued without error. Returns
// the first error, or 0; nothing after it is enqueued.
int routed_chain_launch(const long long* prog, int len, const float* x, long long n_x,
                        float* y, void* scratch, int* counts, void* stream) {
  const Bases b{(char*)scratch, (char*)y};
  const cudaStream_t st = (cudaStream_t)stream;
  auto P = [&](int i) { return resolve(prog[i], b); };
  int i = 0;
  while (i < len) {
    const long long op = prog[i];
    if (op < kOpGather || op > kOpZero || i + kOpWords[op] > len) return (int)cudaErrorInvalidValue;
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
      case kOpHDense:  // H n_h n_pad target out
        rc = hdense_launch(P(i + 1), (int)prog[i + 2], prog[i + 3], x, n_x,
                           (const int32_t*)P(i + 4), (float*)P(i + 5), st);
        kernel = 3;
        break;
      case kOpZero:  // ptr bytes
        rc = (int)cudaMemsetAsync(P(i + 1), 0, (size_t)prog[i + 2], st);
        break;
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
