// GroupNorm(G) -> swish, forward and backward, in x's dtype (bf16 or fp32)
// with fp32 statistics and sums: every norm of the kl-f8 autoencoder
// (models/autoencoder_kl.py; the attention block's norms without the swish).
//
// Replaces no TPU kernel: the JAX package has no kl-f8.  The port ran
// silu(nn.GroupNorm(x.float()).to(bf16)) under autocast: PyTorch's fp32
// GroupNorm, a bf16 -> fp32 cast before it and an fp32 -> bf16 cast after
// it, and silu as its own pass, each mirrored in the backward.  These
// kernels read bf16 and write bf16, once each where a group fits the
// card's shared memory.
//
// Per row r = (sample b, group g) of n = (C/G)*H*W values, contiguous in
// NCHW, with rd rounding to x's dtype (a no-op in fp32):
//   forward:   m, var = the row's mean and variance (fp32), rstd =
//              rsqrt(var + eps), as nn.GroupNorm makes them on the card
//              a = rstd*gamma[c],  b = -a*m + beta[c]   (each rounded)
//              z = rd(fma(a, x, b))
//              y = rd(z / (1 + exp(-z)))  with the swish, else y = z
//   backward:  dz = rd(dy * s * (1 + z*(1 - s))), s = 1/(1 + exp(-z)),
//              with the swish (PyTorch's silu backward), else dz = dy
//              xhat = (x - m)*rstd,  dbeta[c] = sum dz,  dgamma[c] = sum dz*xhat
//              dxhat = dz*gamma[c]
//              dx = rd(rstd*(dxhat - mean(dxhat) - xhat*mean(dxhat*xhat)))
// with sum dxhat = sum_c gamma[c]*dbeta[b,c] and sum dxhat*xhat =
// sum_c gamma[c]*dgamma[b,c] over the row's channels, so that the
// per-channel sums serve both.  mean and rstd are [B, G] fp32; dgamma and
// dbeta [C] fp32, summed over the batch here in a fixed order.  No float
// atomics anywhere and no sum whose order depends on scheduling: two
// launches give the same bits.
//
// The forward is the library composition's, bit for bit: m and rstd are
// PyTorch's GroupNorm's (its Welford chains and merges, gn_welford.cuh,
// which gn.cu's statistics run too), a and b are its ComputeFusedParams',
// z its apply's, y its silu's.  The kl-f8 cell's first loss is held
// against nn.GroupNorm's: a forward that parts from it in ~1e-5 of its
// bf16 values read that gap 4x the library's on an H100 (up to 1.8e-3 of
// the 2.3e-3 limit), since the encoder's logvar, exponentiated in the KL,
// magnifies any change of it.  The chains cost a read of x beside the
// apply's read and write.
//
// Bound on an H100 SXM (3.35 TB/s HBM), each input read once and each
// output written once: forward 2|x| (bf16 [12, 256, 256, 256], |x| = 403
// MB: 0.240 ms; [12, 512, 32, 32]: 0.0075 ms), backward 3|x| (0.360 /
// 0.0113 ms).  About 25 fp32 operations a value forward and 70 backward
// (the swish's exp and division, twice in the backward): under the ~20
// per byte at which the arithmetic would bound, so bytes bound both.
//
// The forward, at every shape: two launches.
//   gn_silu_stats_kernel: one CTA a row, the Welford chains (each chain's
//     next 16 values loaded while these are folded): m and rstd.
//     HBM traffic |x|; the row's chains are serial, ~n/512 divisions.
//   gn_silu_apply_kernel: grid (spans, rows), y from x: 2|x|.
//
// The backward takes one of two paths, chosen by shape and dtype alone.
// ops/gn_silu.py::_plan states the rule, once, and passes its choice (k,
// span); make_plan() below checks that the kernels can run it:
//
// The cluster path (gn_silu_bwd_cluster_kernel, then gn_silu_params_kernel;
// rows of 16-byte units, channels of a multiple of 32 units): a thread-block
// cluster of k <= 8 CTAs a row, CTA
// `rank` holding units [rank*span, rank*span + span) of the row's x in
// shared memory (cp.async, 16 bytes a thread).  The rule's k is the least
// from k0 = min(8, ceil(264 / rows)) (two CTAs an SM at least where the
// rows are few) whose span fits 96 KiB (two CTAs an SM), else 208 KiB
// (one); rows above 8 x 208 KiB take the generic path.  dy is read once for the
// per-channel sums (each warp's 32 units lie in one channel: a lane sum,
// one warp sum when the channel changes, a slot per (warp, channel), the
// warps summed in order), the row's two sums are exchanged in rank order
// through distributed shared memory, then dy is read again for dx, by then
// mostly from L2 (two CTAs an SM hold at most 2 x 132 x 96 KiB of dy, 25
// MB of the 50 MB): HBM traffic 3|x| while L2 holds it.  Each CTA writes
// its channels' sums to a [rows, k, Q] buffer (Q: the most channels a span
// meets), which gn_silu_params_kernel sums over the batch.
// The generic path (any shape: odd H*W, rows too large): spans of
// kThreads*4 units a CTA, gn_silu_bwd_sums_kernel (per channel of the
// span, a block sum each), gn_silu_bwd_dx_kernel (the row's sums merged,
// then dx), then gn_silu_params_kernel: 5|x|.
//
// C interface, for ctypes: each entry returns the cudaError_t of its
// launches (0 on success), or cudaErrorInvalidValue for a dtype, shape,
// path, workspace or alignment it does not take.  The caller allocates
// every buffer and passes its current stream; nothing here allocates or
// synchronises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

#include "gn_welford.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGenericSpan = kThreads * 4;     // units a generic CTA
constexpr int kMaxCluster = 8;                 // portable clusters
constexpr int64_t kSoloBudget = 208 * 1024;    // span bytes, one CTA an SM
constexpr int kMaxQ = 32;                      // channels a cluster span meets
constexpr int kMaxGridY = 65535;
constexpr int kBatch = 4;                      // units in flight a thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float rd(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One unit of a row: 16 bytes (kVec) or one value, as P fp32 values;
// load_raw issues the load and unpack converts it, so that a thread can
// have kBatch loads in flight before it uses the first.
template <typename T, bool kVec>
struct Unit;

template <>
struct Unit<float, true> {
  static constexpr int P = 4;
  using Raw = float4;
  __device__ static Raw load_raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void unpack(const Raw& v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void load(const float* p, float* f) {
    unpack(load_raw(p), f);
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// a bf16 is the top half of its fp32; element 0 is the low half of word 0
template <>
struct Unit<__nv_bfloat16, true> {
  static constexpr int P = 8;
  using Raw = uint4;
  __device__ static Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const Raw& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    unpack(load_raw(p), f);
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                   pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

template <typename T>
struct Unit<T, false> {
  static constexpr int P = 1;
  using Raw = T;
  __device__ static Raw load_raw(const T* p) { return *p; }
  __device__ static void unpack(const Raw& v, float* f) { f[0] = to_float(v); }
  __device__ static void load(const T* p, float* f) { f[0] = to_float(*p); }
  __device__ static void store(T* p, const float* f) {
    *p = from_float<T>(f[0]);
  }
};

// PyTorch's silu and its backward, in fp32 (its opmath for bf16)
__device__ __forceinline__ float swish(float z) {
  return z / (1.0f + expf(-z));
}

__device__ __forceinline__ float swish_grad(float dy, float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return dy * s * (1.0f + z * (1.0f - s));
}

// The per-channel affine of the forward, as nn.GroupNorm makes it on the
// card (ComputeFusedParamsCUDAKernel): a = rstd*gamma and b = -a*m + beta,
// each operation rounded.
struct Affine {
  float a, b;
};

__device__ __forceinline__ Affine affine(float m, float rstd, float g,
                                         float bt) {
  const float a = __fmul_rn(rstd, g);
  return {a, __fadd_rn(__fmul_rn(-a, m), bt)};
}

// z as the forward stores it (the apply's one fused multiply-add), and
// dL/dz in x's dtype
template <typename T>
__device__ __forceinline__ float z_of(float x, Affine af) {
  return rd<T>(__fmaf_rn(af.a, x, af.b));
}

template <typename T>
__device__ __forceinline__ float dz_of(float dy, float z, bool with_swish) {
  return with_swish ? rd<T>(swish_grad(dy, z)) : dy;
}

// n / d for n < 2^31 by a multiply and a shift (d >= 1), made on the host
struct FastDiv {
  uint32_t mul, shift;
};

FastDiv make_div(uint32_t d) {
  uint32_t l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint64_t m = ((uint64_t{1} << 32) * ((uint64_t{1} << l) - d)) / d + 1;
  return {static_cast<uint32_t>(m), l};
}

__device__ __forceinline__ int quotient(int n, FastDiv f) {
  const uint32_t u = static_cast<uint32_t>(n);
  return static_cast<int>((__umulhi(u, f.mul) + u) >> f.shift);
}

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, off);
    v.y += __shfl_xor_sync(kFull, v.y, off);
  }
  return v;
}

// lane l with lane l + 16, 8, 4, 2, 1: a fixed tree; every lane gets lane
// 0's result
__device__ __forceinline__ float2 warp_tree2(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(kFull, v.x, off);
    v.y += __shfl_down_sync(kFull, v.y, off);
  }
  return make_float2(__shfl_sync(kFull, v.x, 0), __shfl_sync(kFull, v.y, 0));
}

// v summed over the block in a fixed order, returned to every thread;
// `scratch` holds kWarps float2 and is free again on return.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* scratch) {
  v = warp_sum2(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t.x += scratch[w].x;
    t.y += scratch[w].y;
  }
  __syncthreads();
  return t;
}

// A row's units [0, N): span s is [s*span, min(N, s*span + span)).
__device__ __forceinline__ int span_units(int s, int span, int N) {
  const int lo = s * span;
  return lo >= N ? 0 : min(span, N - lo);
}

// y of the `cnt` units of span [lo, lo + cnt) of row r from `src` (its
// copy: global or shared memory), to y (global).
template <typename T, bool kVec>
__device__ __forceinline__ void span_apply(const T* src, T* yr, int lo,
                                           int cnt, float m, float rstd,
                                           const float* gamma,
                                           const float* beta, int c0,
                                           FastDiv by_v, bool with_swish) {
  using U = Unit<T, kVec>;
  for (int i0 = threadIdx.x; i0 < cnt; i0 += kThreads * kBatch) {
    typename U::Raw raw[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i < cnt) raw[b] = U::load_raw(src + static_cast<int64_t>(i) * U::P);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i >= cnt) break;
      const int u = lo + i;
      const int c = c0 + quotient(u, by_v);
      const Affine af = affine(m, rstd, gamma[c], beta[c]);
      float f[U::P];
      U::unpack(raw[b], f);
#pragma unroll
      for (int j = 0; j < U::P; ++j) {
        const float z = z_of<T>(f[j], af);
        f[j] = with_swish ? swish(z) : z;
      }
      U::store(yr + static_cast<int64_t>(u) * U::P, f);
    }
  }
}

// dx of the `cnt` units of span [lo, lo + cnt), x from `src`, dy and dx
// the row's.
template <typename T, bool kVec>
__device__ __forceinline__ void span_dx(const T* src, const T* dyr, T* dxr,
                                        int lo, int cnt, float m, float rstd,
                                        float mean_dxhat, float mean_dxhat_xhat,
                                        const float* gamma, const float* beta,
                                        int c0, FastDiv by_v,
                                        bool with_swish) {
  using U = Unit<T, kVec>;
  for (int i0 = threadIdx.x; i0 < cnt; i0 += kThreads * kBatch) {
    typename U::Raw rx[kBatch], rdy[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i < cnt) {
        rx[b] = U::load_raw(src + static_cast<int64_t>(i) * U::P);
        rdy[b] = U::load_raw(dyr + static_cast<int64_t>(lo + i) * U::P);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i >= cnt) break;
      const int u = lo + i;
      const int c = c0 + quotient(u, by_v);
      const float g = gamma[c];
      const Affine af = affine(m, rstd, g, beta[c]);
      float f[U::P], d[U::P];
      U::unpack(rx[b], f);
      U::unpack(rdy[b], d);
#pragma unroll
      for (int j = 0; j < U::P; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(f[j], m), rstd);
        const float dz = dz_of<T>(d[j], z_of<T>(f[j], af), with_swish);
        const float t = __fsub_rn(__fsub_rn(__fmul_rn(dz, g), mean_dxhat),
                                  __fmul_rn(xhat, mean_dxhat_xhat));
        f[j] = __fmul_rn(rstd, t);
      }
      U::store(dxr + static_cast<int64_t>(u) * U::P, f);
    }
  }
}

// ---------------------------------------------------------------------------
// cluster path
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Every thread of every CTA of the cluster arrives (release); wait returns
// once all have (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// This CTA's units of the row into shared memory.
template <typename T>
__device__ __forceinline__ void load_span(uint4* sx, const T* xr, int lo,
                                          int cnt) {
  const uint4* src = reinterpret_cast<const uint4*>(xr) + lo;
  for (int i = threadIdx.x; i < cnt; i += kThreads) cp_async16(sx + i, src + i);
  cp_async_wait_all();
  __syncthreads();
}

// grid (k, rows), clusters of (k, 1, 1), x's span in shared memory.  `chan`
// [rows, k, Q] gets each CTA's per-channel (sum dz, sum dz*xhat).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gn_silu_bwd_cluster_kernel(const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd_in,
                               const T* __restrict__ dy, T* __restrict__ dx,
                               float2* __restrict__ chan, int64_t n, int N,
                               int span, int V, int G, int cpg, int Q,
                               FastDiv by_v, int with_swish) {
  using U = Unit<T, true>;
  extern __shared__ uint4 sx[];
  __shared__ float2 wslots[kWarps][kMaxQ];
  __shared__ float2 qtot[kMaxQ];
  __shared__ float2 slot;   // this CTA's (sum dxhat, sum dxhat*xhat)
  __shared__ float2 tot;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = static_cast<int>(cluster.num_blocks());
  const int r = blockIdx.y;
  const int lo = rank * span;
  const int cnt = span_units(rank, span, N);
  const int c0 = (r % G) * cpg;
  const int q0 = lo / V;   // the span's first channel in the row
  const bool sw = with_swish != 0;
  const int64_t off = static_cast<int64_t>(r) * n;
  for (int i = threadIdx.x; i < kWarps * kMaxQ; i += kThreads) {
    wslots[i / kMaxQ][i % kMaxQ] = make_float2(0.0f, 0.0f);
  }
  load_span(sx, x + off, lo, cnt);
  const T* src = reinterpret_cast<const T*>(sx);
  const T* dyr = dy + off;
  const float m = mean[r], rstd = rstd_in[r];
  // pass 1: each warp's chunk of 32 units lies in one channel (V and span
  // multiples of 32), and a warp's channels never decrease
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2 acc = make_float2(0.0f, 0.0f);
  int cur = -1;
  Affine af = {0.0f, 0.0f};
  for (int w0 = warp * 32; w0 < cnt; w0 += kThreads * kBatch) {
    typename U::Raw rdy[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i0 = w0 + b * kThreads;
      if (i0 < cnt) {
        rdy[b] = U::load_raw(dyr + static_cast<int64_t>(lo + i0 + lane) * U::P);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i0 = w0 + b * kThreads;   // warp-uniform
      if (i0 >= cnt) break;
      const int q = quotient(lo + i0, by_v);
      if (q != cur) {
        if (cur >= 0) {
          const float2 w = warp_sum2(acc);
          if (lane == 0) wslots[warp][cur - q0] = w;
        }
        cur = q;
        acc = make_float2(0.0f, 0.0f);
        af = affine(m, rstd, gamma[c0 + q], beta[c0 + q]);
      }
      float f[U::P], d[U::P];
      U::load(src + static_cast<int64_t>(i0 + lane) * U::P, f);
      U::unpack(rdy[b], d);
#pragma unroll
      for (int j = 0; j < U::P; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(f[j], m), rstd);
        const float dz = dz_of<T>(d[j], z_of<T>(f[j], af), sw);
        acc.x += dz;
        acc.y = fmaf(dz, xhat, acc.y);
      }
    }
  }
  if (cur >= 0) {
    const float2 w = warp_sum2(acc);
    if (lane == 0) wslots[warp][cur - q0] = w;
  }
  __syncthreads();
  const int nq = cnt > 0 ? (lo + cnt - 1) / V - q0 + 1 : 0;
  if (threadIdx.x < Q) {
    const int q = threadIdx.x;
    float2 t = make_float2(0.0f, 0.0f);
    if (q < nq) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        t.x += wslots[w][q].x;
        t.y += wslots[w][q].y;
      }
    }
    qtot[q] = t;
    chan[(static_cast<int64_t>(r) * k + rank) * Q + q] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 s = make_float2(0.0f, 0.0f);
    for (int q = 0; q < nq; ++q) {
      const float g = gamma[c0 + q0 + q];
      s.x = fmaf(g, qtot[q].x, s.x);
      s.y = fmaf(g, qtot[q].y, s.y);
    }
    slot = s;
  }
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x < 32) {
    float2 p = make_float2(0.0f, 0.0f);
    if (threadIdx.x < k) p = *cluster.map_shared_rank(&slot, threadIdx.x);
    p = warp_tree2(p);
    if (threadIdx.x == 0) tot = p;
  }
  cluster_arrive();   // done with the peers' slots
  __syncthreads();
  const float nf = static_cast<float>(n);
  span_dx<T, true>(src, dyr, dx + off, lo, cnt, m, rstd, tot.x / nf,
                   tot.y / nf, gamma, beta, c0, by_v, sw);
  cluster_wait();     // no CTA leaves while a peer may read its slot
}

// ---------------------------------------------------------------------------
// generic path
// ---------------------------------------------------------------------------

using gn_welford::kChains;
using gn_welford::Welford;

// grid (rows), kChains threads: PyTorch's chains over row r
// (gn_welford.cuh) merged as its block reduce merges them; m and rstd of
// the row.
template <typename T>
__global__ void __launch_bounds__(kChains)
    gn_silu_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                         float* __restrict__ rstd, int64_t n, float eps) {
  __shared__ Welford warps[gn_welford::kSlots];
  const int r = blockIdx.x, t = threadIdx.x;
  const Welford w = gn_welford::warp_merge(
      gn_welford::chain(x + static_cast<int64_t>(r) * n, n, t));
  if (t % 32 == 0) warps[t / 32] = w;
  __syncthreads();
  if (t < 32) {
    const Welford v = gn_welford::merge_slots(warps);
    if (t == 0) {
      mean[r] = v.mean;
      rstd[r] = gn_welford::rstd_of(v, eps);
    }
  }
}

// grid (S, rows): y of span s of row r from the row's m and rstd.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_silu_apply_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd, T* __restrict__ y,
                         int64_t n, int N, int span, int G, int cpg,
                         FastDiv by_v, int with_swish) {
  constexpr int P = Unit<T, kVec>::P;
  const int s = blockIdx.x, r = blockIdx.y;
  const int lo = s * span;
  const int64_t off = static_cast<int64_t>(r) * n;
  span_apply<T, kVec>(x + off + static_cast<int64_t>(lo) * P, y + off, lo,
                      span_units(s, span, N), mean[r], rstd[r], gamma, beta,
                      (r % G) * cpg, by_v, with_swish != 0);
}

// grid (S, rows): chan[(r*S + s)*Q + q] = channel (s's first + q)'s
// (sum dz, sum dz*xhat) over span s, zero past its channels; pair[r*S + s]
// = their sum weighted by gamma, in channel order.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_silu_bwd_sums_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd_in,
                            const T* __restrict__ dy,
                            float2* __restrict__ chan,
                            float2* __restrict__ pair, int64_t n, int N,
                            int span, int V, int G, int cpg, int Q,
                            int with_swish) {
  using U = Unit<T, kVec>;
  __shared__ float2 scratch[kWarps];
  const int s = blockIdx.x, r = blockIdx.y, S = gridDim.x;
  const int lo = s * span, hi = lo + span_units(s, span, N);
  const int c0 = (r % G) * cpg;
  const int q0 = lo / V, q1 = (hi - 1) / V;
  const float m = mean[r], rstd = rstd_in[r];
  const bool sw = with_swish != 0;
  const int64_t off = static_cast<int64_t>(r) * n;
  float2* out = chan + (static_cast<int64_t>(r) * S + s) * Q;
  float2 grp = make_float2(0.0f, 0.0f);
  for (int q = q0; q <= q1; ++q) {
    const float g = gamma[c0 + q];
    const Affine af = affine(m, rstd, g, beta[c0 + q]);
    float2 acc = make_float2(0.0f, 0.0f);
    const int e = min(hi, (q + 1) * V);
    for (int u0 = max(lo, q * V) + threadIdx.x; u0 < e;
         u0 += kThreads * kBatch) {
      typename U::Raw rx[kBatch], rdy[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int u = u0 + b * kThreads;
        if (u < e) {
          rx[b] = U::load_raw(x + off + static_cast<int64_t>(u) * U::P);
          rdy[b] = U::load_raw(dy + off + static_cast<int64_t>(u) * U::P);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (u0 + b * kThreads >= e) break;
        float f[U::P], d[U::P];
        U::unpack(rx[b], f);
        U::unpack(rdy[b], d);
#pragma unroll
        for (int j = 0; j < U::P; ++j) {
          const float xhat = __fmul_rn(__fsub_rn(f[j], m), rstd);
          const float dz = dz_of<T>(d[j], z_of<T>(f[j], af), sw);
          acc.x += dz;
          acc.y = fmaf(dz, xhat, acc.y);
        }
      }
    }
    const float2 t = block_sum2(acc, scratch);
    if (threadIdx.x == 0) {
      out[q - q0] = t;
      grp.x = fmaf(g, t.x, grp.x);
      grp.y = fmaf(g, t.y, grp.y);
    }
  }
  if (threadIdx.x == 0) {
    for (int q = q1 - q0 + 1; q < Q; ++q) out[q] = make_float2(0.0f, 0.0f);
    pair[static_cast<int64_t>(r) * S + s] = grp;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_silu_bwd_dx_kernel(const T* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd_in,
                          const T* __restrict__ dy,
                          const float2* __restrict__ pair, T* __restrict__ dx,
                          int64_t n, int N, int span, int G, int cpg,
                          FastDiv by_v, int with_swish) {
  constexpr int P = Unit<T, kVec>::P;
  __shared__ float2 tot;
  const int s = blockIdx.x, r = blockIdx.y, S = gridDim.x;
  if (threadIdx.x < 32) {
    float2 p = make_float2(0.0f, 0.0f);
    for (int i = threadIdx.x; i < S; i += 32) {
      const float2 v = pair[static_cast<int64_t>(r) * S + i];
      p.x += v.x;
      p.y += v.y;
    }
    p = warp_tree2(p);
    if (threadIdx.x == 0) tot = p;
  }
  __syncthreads();
  const float nf = static_cast<float>(n);
  const int lo = s * span;
  const int64_t off = static_cast<int64_t>(r) * n;
  span_dx<T, kVec>(x + off + static_cast<int64_t>(lo) * P, dy + off, dx + off,
                   lo, span_units(s, span, N), mean[r], rstd_in[r],
                   tot.x / nf, tot.y / nf, gamma, beta, (r % G) * cpg, by_v,
                   with_swish != 0);
}

// ---------------------------------------------------------------------------
// both paths: dgamma and dbeta over the batch
// ---------------------------------------------------------------------------

// A warp a channel c: the (b, span) partials of c, b-major, lane l summing
// items l, l + 32, ..., then the lanes in a fixed tree.
__global__ void __launch_bounds__(kThreads)
    gn_silu_params_kernel(const float2* __restrict__ chan,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta, int B, int C, int G,
                          int cpg, int S, int span, int V, int Q) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= C) return;   // the whole warp: no barrier follows
  const int lane = threadIdx.x % 32;
  const int g = c / cpg, q = c % cpg;
  const int s0 = q * V / span, s1 = ((q + 1) * V - 1) / span;
  const int ns = s1 - s0 + 1;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = lane; i < B * ns; i += 32) {
    const int b = i / ns, s = s0 + i % ns;
    const float2 v =
        chan[((static_cast<int64_t>(b) * G + g) * S + s) * Q +
             (q - s * span / V)];
    acc.x += v.x;
    acc.y += v.y;
  }
  acc = warp_tree2(acc);
  if (lane == 0) {
    dbeta[c] = acc.x;
    dgamma[c] = acc.y;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// How a shape runs: units of P values (16 bytes where H*W allows, else one
// value), V a channel, N a row; k > 0 the cluster path's CTAs a row, 0 the
// generic path; S spans of `span` units a row; Q the most channels a span
// meets.
struct Plan {
  int P, V, N, k, span, S, Q;
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The plan of a shape on the caller's path (k, span), or false where the
// kernels cannot run it: a cluster span must be whole warps of 16-byte
// units, cover the row in k CTAs, fit one CTA's shared memory and meet at
// most kMaxQ channels.  Which path and span a shape takes is the caller's
// choice (ops/gn_silu.py::_plan states the rule, once).
bool make_plan(int B, int C, int HW, int G, int es, int k, int span,
               Plan* p) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
      static_cast<int64_t>(B) * G > kMaxGridY ||
      static_cast<int64_t>(C / G) * HW >= (int64_t{1} << 31) || k < 0 ||
      k > kMaxCluster || span <= 0) {
    return false;
  }
  const int cpg = C / G;
  const int per16 = 16 / es;
  p->P = HW % per16 == 0 ? per16 : 1;
  p->V = HW / p->P;
  p->N = cpg * p->V;
  p->k = k;
  p->span = span;
  p->S = k > 0 ? k : static_cast<int>(ceil_div(p->N, span));
  const int64_t q = (static_cast<int64_t>(span) - 1) / p->V + 2;
  p->Q = static_cast<int>(q < cpg ? q : cpg);
  return k == 0 ||
         (p->P > 1 && p->V % 32 == 0 && span % 32 == 0 &&
          static_cast<int64_t>(span) * 16 <= kSoloBudget &&
          static_cast<int64_t>(k) * span >= p->N && p->Q <= kMaxQ);
}

// fp32 scratch the backward needs: the per-channel partials and (generic)
// the rows' span pairs.
int64_t work_floats(const Plan& p, int64_t rows) {
  return 2 * rows * p.S * p.Q + (p.k > 0 ? 0 : 2 * rows * p.S);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Sets, once per kernel and device, the largest dynamic shared memory the
// cluster kernels ask for.
cudaError_t configure(const void* kernel, int device) {
  struct Entry {
    const void* kernel;
    int device;
  };
  static std::mutex mu;
  static Entry done[16];
  static int n = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    if (done[i].kernel == kernel && done[i].device == device) {
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSoloBudget));
  if (err != cudaSuccess) return err;
  if (n < 16) done[n++] = {kernel, device};
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, const Plan& p, int rows,
                           cudaStream_t st, int device, Args... args) {
  cudaError_t err = configure(reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.k, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.span) * 16;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t apply(const T* x, const float* gamma, const float* beta,
                  const float* mean, const float* rstd, T* y, int N, int64_t n,
                  int rows, int G, int cpg, int V, int with_swish,
                  cudaStream_t st) {
  const int S = static_cast<int>(ceil_div(N, kGenericSpan));
  gn_silu_apply_kernel<T, kVec><<<dim3(S, rows), kThreads, 0, st>>>(
      x, gamma, beta, mean, rstd, y, n, N, kGenericSpan, G, cpg, make_div(V),
      with_swish);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* xv, const float* gamma, const float* beta,
                    void* yv, float* mean, float* rstd, const Plan& p,
                    int64_t n, int rows, int G, int cpg, float eps,
                    int with_swish, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  gn_silu_stats_kernel<T><<<rows, kChains, 0, st>>>(x, mean, rstd, n, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return p.P > 1 ? apply<T, true>(x, gamma, beta, mean, rstd, y, p.N, n, rows,
                                  G, cpg, p.V, with_swish, st)
                 : apply<T, false>(x, gamma, beta, mean, rstd, y, p.N, n,
                                   rows, G, cpg, p.V, with_swish, st);
}

template <typename T, bool kVec>
cudaError_t backward_generic(const T* x, const float* gamma,
                             const float* beta, const float* mean,
                             const float* rstd, const T* dy, T* dx,
                             float2* chan, float2* pair, const Plan& p,
                             int64_t n, int rows, int G, int cpg,
                             int with_swish, cudaStream_t st) {
  const dim3 grid(p.S, rows);
  gn_silu_bwd_sums_kernel<T, kVec><<<grid, kThreads, 0, st>>>(
      x, gamma, beta, mean, rstd, dy, chan, pair, n, p.N, p.span, p.V, G, cpg,
      p.Q, with_swish);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_silu_bwd_dx_kernel<T, kVec><<<grid, kThreads, 0, st>>>(
      x, gamma, beta, mean, rstd, dy, pair, dx, n, p.N, p.span, G, cpg,
      make_div(p.V), with_swish);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* xv, const float* gamma, const float* beta,
                     const float* mean, const float* rstd, const void* dyv,
                     void* dxv, float* dgamma, float* dbeta, float* work,
                     const Plan& p, int B, int C, int G, int64_t n,
                     int with_swish, cudaStream_t st, int device) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const int rows = B * G, cpg = C / G;
  float2* chan = reinterpret_cast<float2*>(work);
  cudaError_t err;
  if (p.k > 0) {
    err = launch_cluster(gn_silu_bwd_cluster_kernel<T>, p, rows, st, device,
                         x, gamma, beta, mean, rstd, dy, dx, chan, n, p.N,
                         p.span, p.V, G, cpg, p.Q, make_div(p.V), with_swish);
  } else {
    float2* pair = chan + static_cast<int64_t>(rows) * p.S * p.Q;
    err = p.P > 1 ? backward_generic<T, true>(x, gamma, beta, mean, rstd, dy,
                                              dx, chan, pair, p, n, rows, G,
                                              cpg, with_swish, st)
                  : backward_generic<T, false>(x, gamma, beta, mean, rstd, dy,
                                               dx, chan, pair, p, n, rows, G,
                                               cpg, with_swish, st);
  }
  if (err != cudaSuccess) return err;
  gn_silu_params_kernel<<<static_cast<unsigned>(ceil_div(C, kWarps)),
                          kThreads, 0, st>>>(chan, dgamma, dbeta, B, C, G,
                                             cpg, p.S, p.span, p.V, p.Q);
  return cudaGetLastError();
}

// The plan of a dtype code, shape and path, and the tensors 16-byte aligned
// where the plan reads 16-byte units.
bool plan_ok(int B, int C, int HW, int G, int dtype, int k, int span,
             Plan* p, std::initializer_list<const void*> tensors) {
  if (dtype != 0 && dtype != 1) return false;
  if (!make_plan(B, C, HW, G, dtype == 1 ? 2 : 4, k, span, p)) return false;
  if (p->P > 1) {
    for (const void* t : tensors) {
      if (!aligned16(t)) return false;
    }
  }
  return true;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  y in x's dtype; mean and rstd
// [B, G].
extern "C" int betavae_gn_silu_fwd(const void* x, const float* gamma,
                                   const float* beta, void* y, float* mean,
                                   float* rstd, int B, int C, int HW, int G,
                                   float eps, int dtype, int swish,
                                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  if (!plan_ok(B, C, HW, G, dtype, 0, kGenericSpan, &p, {x, y})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(C / G) * HW;
  err = dtype == 1
            ? forward<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, p, n,
                                     B * G, G, C / G, eps, swish, st)
            : forward<float>(x, gamma, beta, y, mean, rstd, p, n, B * G, G,
                             C / G, eps, swish, st);
  return static_cast<int>(err);
}

// dx in x's dtype; dgamma, dbeta [C], summed over the batch, on the path
// (k, span) the caller gives; `work`: `work_len` floats of fp32 scratch, at
// least betavae_gn_silu_work's.
extern "C" int betavae_gn_silu_bwd(const void* x, const float* gamma,
                                   const float* beta, const float* mean,
                                   const float* rstd, const void* dy,
                                   void* dx, float* dgamma, float* dbeta,
                                   float* work, long long work_len, int B,
                                   int C, int HW, int G, int dtype,
                                   int swish, int k, int span, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  if (!plan_ok(B, C, HW, G, dtype, k, span, &p, {x, dy, dx}) ||
      work_len < work_floats(p, static_cast<int64_t>(B) * G)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(C / G) * HW;
  err = dtype == 1
            ? backward<__nv_bfloat16>(x, gamma, beta, mean, rstd, dy, dx,
                                      dgamma, dbeta, work, p, B, C, G, n,
                                      swish, st, device)
            : backward<float>(x, gamma, beta, mean, rstd, dy, dx, dgamma,
                              dbeta, work, p, B, C, G, n, swish, st, device);
  return static_cast<int>(err);
}

// The fp32 scratch floats the backward takes on the path (k, span), or -1
// for a shape, dtype or path the kernels do not take.
extern "C" long long betavae_gn_silu_work(int B, int C, int HW, int G,
                                          int dtype, int k, int span) {
  Plan p;
  if ((dtype != 0 && dtype != 1) ||
      !make_plan(B, C, HW, G, dtype == 1 ? 2 : 4, k, span, &p)) {
    return -1;
  }
  return work_floats(p, static_cast<int64_t>(B) * G);
}
