// GroupNorm with one group -> ReLU -> per-channel spatial mean (the SE
// squeeze), forward and backward.
//
// Replaces the Pallas TPU kernels of betavae_tpu/ops/pallas_gn.py:
//
//   _fwd_kernel (launched by _run_fwd, pallas_call at pallas_gn.py:123;
//                _run_fwd at :113), per sample b over all C*H*W values:
//       m, v = the sample's mean and variance,  rstd = rsqrt(v + eps)
//       a = rstd*gamma[c],  z = a*x + (beta[c] - a*m),  y = max(z, 0)
//       pooled[b,c] = mean_hw(rd(y))
//   _bwd_kernel (launched by _run_bwd, pallas_call at pallas_gn.py:149;
//                _run_bwd at :139), given gy = dL/dy and gp = dL/dpooled:
//       gz = rd(gy + rd(gp[b,c]/HW)) * 1[z > 0]
//       xhat = (x - m)*rstd,  dbeta[b,c] = sum_hw gz,  dgamma[b,c] = sum_hw gz*xhat
//       dxhat = gz*gamma[c]
//       dx = rstd*(dxhat - mean(dxhat) - xhat*mean(dxhat*xhat))
//
// x, y, gy and dx are NCHW in bf16 or fp32; gamma, beta [C], gp, pooled,
// dgamma and dbeta [B, C] and m, rstd [B] are fp32, and every sum and
// product is fp32.  rd rounds to x's dtype (a no-op in fp32): the squeeze
// is the mean of y as it is stored, and dL/dy is its two parts (through y,
// and through pooled: the mean's backward in y's dtype) summed in y's
// dtype, as a bf16 model's autograd gives them: the JAX model's flax blocks
// (GroupNorm, then the SE block's mean of the bf16 activations) and
// PyTorch's GroupNorm under autocast; the Pallas kernel pools the fp32 y.
// The per-sample partials dgamma and dbeta are summed over B by the
// caller, as the JAX package's _gn_bwd does.
//
// m, v and z are PyTorch's GroupNorm's on the card, bit for bit (the JAX
// kernel takes v = sum(x*x)/n - m*m and z = xhat*gamma + beta): Welford's
// update over kChains interleaved chains of each sample, the chains merged
// in PyTorch's block-reduce order, and z rounded as its GroupNorm rounds it
// (see "the statistics" below).  A bf16 model's forward then gives the
// bits of nn.GroupNorm under autocast, which the benchmark's reference
// runs, where any other rounding of m, rstd or z moves a few y values by
// one bf16 step and the first loss of the scaled configuration by ~1e-4.
//
// Bound on an H100 SXM (3.35 TB/s HBM; 67 TFLOP/s fp32 outside the tensor
// cores), counting each input read once and each output written once:
//   forward:  read x, write y: 2|x|.  bf16 [32, 64, 64, 64] (|x| = 16.8
//             MB): 0.0100 ms; [32, 512, 8, 8]: 0.00125 ms.
//   backward: read x and gy, write dx: 3|x|: 0.0150 / 0.0019 ms.
// About 9 fp32 operations per value forward and 16 backward, under 9 per
// byte of bf16: far below the ~20 per byte where the arithmetic would
// limit.  Both are bound by bytes.
//
// The forward, at every shape: two launches, no atomics.
//     gn_stats (below): each sample's Welford slots.
//     gn_apply: grid (ceil(C/cpb), B); each block merges its sample's
//       slots in one fixed order (every block of the sample gets the same
//       bits) into m and rstd, and walks its channels' H*W planes
//       (contiguous in NCHW), writing y and the channel's pooled mean; the
//       sample's first block writes m and rstd.  HBM traffic 3|x| (the
//       stats pass reads x once).  The forward needs no exchange within a
//       sample once the statistics are made, so it takes no cluster: a
//       cluster kernel that held each slice in shared memory read each value
//       once, as this one does.
//
// The backward takes one of two paths.  The caller names the path
// (ops/gn.py::gn_path states the rule, betavae_gn_path below states the
// same rule in C) and the entry point launches exactly that path or
// returns an error: there is no fallback.
//
// The cluster path, one launch (gn_bwd_cluster_kernel).
//   The TPU kernel keeps one whole sample in VMEM and makes a single HBM
//   read of it and a single write (pallas_gn.py:1-26).  On Hopper the
//   counterpart of "one sample on chip" is one thread-block cluster per
//   sample: a grid of B clusters of k CTAs, each CTA owning a contiguous run
//   of whole channels of its sample (contiguous in NCHW, so each channel's
//   dbeta and dgamma never leave its CTA), held in shared memory: each warp
//   bulk-copies its share of the slice (cp.async.bulk onto an mbarrier;
//   plain loads where the slice is not 16-byte aligned).  gy is read from
//   HBM in the first pass (per-channel dbeta, dgamma) and read again in the
//   second (dx), by then from L2.  gy is not held in shared memory: that
//   would double a CTA's shared memory, and the rule's budget (three CTAs
//   an SM, below) is set for x alone.  The per-sample sums sum_c
//   gamma_c*dbeta and sum_c gamma_c*dgamma (sum dxhat and sum dxhat*xhat)
//   cross the cluster through distributed shared memory (DSMEM), exchanged
//   in rank order.  HBM traffic 3|x| while L2 (50 MB) holds the resident
//   CTAs' gy: at most three slices of 72 KiB on each of 132 SMs, 28.5 MB.
//   Inside a CTA, 256 threads walk the slice as 16-byte units (one value
//   where the rows do not allow 16 bytes), whatever the plane size: warp w
//   takes a contiguous range of units, 32 consecutive units a chunk.  A
//   per-channel sum is a segmented reduction: a chunk within one channel
//   adds to each lane's running sum, a chunk across channels is a
//   segmented scan by shuffles within the lanes that share a channel; one
//   partial per (channel, warp), summed over warps in index order.  No
//   lane idles at 8x8.  No atomics and no float sum whose order depends on
//   scheduling: two launches give the same bits.
//   The rule for k (cluster_k): k0 = min(8, 264 / B, C), so that B*k CTAs
//   put two on each of the H100's 132 SMs where B allows (k = 8 at B =
//   32); then the least k in [k0, min(8, C)] whose largest slice, ceil(C/k)
//   channels, fits the budget: ceil(C/k)*(H*W*elem + 24) <= 72 KiB (the 24
//   bytes: gamma, beta, gp/HW and two per-warp partials a channel), so
//   that three CTAs share an SM.  Why not one CTA an SM: the card holds at
//   once only 30 clusters of 4, or 15 of 8, at one CTA an SM (its GPCs
//   leave 120 SMs to such clusters), so B = 32 at k = 4 ran as two waves;
//   at three CTAs an SM all 32 clusters of 8 are resident.  Clusters stay
//   portable (<= 8 CTAs); a launch takes up to 16 (a non-portable size)
//   and a slice up to 224 KiB when the caller asks.
//
// The generic path: every shape whose sample does not fit a cluster (the
// flagship's largest block, [32, 64, 128, 128], is 2 MiB a sample in bf16),
// two launches, no atomics, on the forward's grid:
//     gn_bwd_sums: per channel, sum_hw gz and gz*xhat give dbeta and dgamma.
//     gn_bwd_dx: the per-sample means need no third reduction over the
//       sample: sum dxhat = sum_c gamma_c*dbeta[b,c] and sum dxhat*xhat =
//       sum_c gamma_c*dgamma[b,c].  Each block sums those over C in one
//       fixed order, then writes dx.
//   The two passes move 5|x| unless L2 still holds x and gy from the first.
//
// Channels per block (cpb) of gn_apply and the generic backward: a plane of
// at least kWholeBlockHW values gets the whole block of 256 threads;
// smaller planes get one warp each.
//
// Every kernel forms z as pre_relu does, so that the ReLU mask of the plain
// version given the same m and rstd is the kernel's, bit for bit.
// Values are read and written 16 bytes a thread where the rows allow it
// (the tensors 16-byte aligned and H*W a multiple of 8 bf16 or 4 fp32),
// else one value a thread; offsets into the tensors are 64-bit.
//
// C interface, for ctypes: each entry point returns the cudaError_t of its
// launch (0 on success), or cudaErrorInvalidValue for a dtype code, shape
// or path it does not take.  The caller allocates every buffer and passes
// its current stream; nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "gn_welford.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int64_t kWholeBlockHW = 4096;    // planes this large: cpb = 1
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

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

// rd: v as a T holds it (rounded to nearest even in bf16; v in fp32)
template <typename T>
__device__ __forceinline__ float rd(float v) {
  return to_float(from_float<T>(v));
}

// kPer values of T in one 16-byte load or store, as fp32.
template <typename T>
struct Vec {
  static constexpr int kPer = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f);

template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// a bf16 is the top half of its fp32; element 0 is the low half of word 0
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& raw,
                                                        float* f) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  unpack16<T>(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                 pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// (a, b) summed over a block of kW warps in a fixed order, returned to
// every thread.  `scratch` holds kW float2 and is used by this call only.
template <int kW>
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    total.x += scratch[w].x;
    total.y += scratch[w].y;
  }
  return total;
}

// z = (x - m)*rstd*gamma + beta, each operation rounded on its own (no fma),
// as the plain version's elementwise torch ops round it.
// z, rounded as PyTorch's GroupNorm rounds it (a = rstd*gamma and
// b = -a*m + beta each rounded, then one fused multiply-add), and, for the
// backward's sums, xhat = (x - m)*rstd.
__device__ __forceinline__ float pre_relu(float x, float m, float rstd,
                                          float g, float bt, float* xhat) {
  *xhat = __fmul_rn(__fsub_rn(x, m), rstd);
  const float a = __fmul_rn(rstd, g);
  return __fmaf_rn(a, x, __fadd_rn(__fmul_rn(-a, m), bt));
}

// ---------------------------------------------------------------------------
// the statistics: PyTorch's GroupNorm's, bit for bit (gn_welford.cuh)
// ---------------------------------------------------------------------------
//
// gn_stats_kernel runs PyTorch's chains over each sample and the warp
// merges, and writes each warp's result to the sample's slot; the kernels
// that apply the statistics merge a sample's slots as the block's last
// warp does.

using gn_welford::kChains;
using gn_welford::kSlots;
using gn_welford::Welford;

// grid (kChains / kThreads, B): thread t of sample b runs chain t over the
// sample's n values, and each warp writes its chains, merged, to slot
// t / 32 of the sample (a warp past the chains writes an empty one).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, int64_t n,
                    Welford* __restrict__ slots) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const Welford w = gn_welford::warp_merge(
      gn_welford::chain(x + static_cast<int64_t>(b) * n, n, t));
  if (threadIdx.x % 32 == 0) {
    slots[static_cast<int64_t>(b) * kSlots + t / 32] = w;
  }
}

// (m, rstd) of sample b from its slots, merged in slot order; every lane of
// the calling warp (all 32 call it) gets them.
__device__ __forceinline__ float2 sample_stats(
    const Welford* __restrict__ slots, int b, float eps) {
  const Welford w =
      gn_welford::merge_slots(slots + static_cast<int64_t>(b) * kSlots);
  const float m = __shfl_sync(kFull, w.mean, 0);
  const float m2 = __shfl_sync(kFull, w.m2, 0);
  const float n = __shfl_sync(kFull, w.n, 0);
  return make_float2(m, gn_welford::rstd_of({m, m2, n}, eps));
}

// ---------------------------------------------------------------------------
// generic path
// ---------------------------------------------------------------------------

// v summed over the kGroup threads of one channel (a warp, or the whole
// block), valid in the group's first thread.  Every thread of the block
// calls it.  `scratch` holds kWarps floats and is used by this call only.
template <int kGroup>
__device__ __forceinline__ float group_sum(float v, float* scratch) {
  v = warp_sum(v);
  if constexpr (kGroup == 32) {
    return v;
  } else {
    static_assert(kGroup == kThreads, "a channel takes a warp or the block");
    if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
    __syncthreads();
    float total = 0.0f;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += scratch[w];
    }
    return total;
  }
}

// Calls f(values, count) on this thread's share of plane[0, len): with kVec
// (the caller's guarantee: plane 16-byte aligned, len a multiple of kPer),
// runs of kPer values at once, kUnroll runs loaded before any is used;
// else one value at a time.  `t` is the thread's index among `stride`
// threads that share the plane.  f may also store through the offsets it
// is given, as apply() below does.
template <typename T, bool kVec, typename F>
__device__ __forceinline__ void for_plane(const T* __restrict__ plane,
                                          int64_t len, int t, int stride,
                                          F&& f) {
  if constexpr (kVec) {
    constexpr int P = Vec<T>::kPer;
    const int64_t nvec = len / P;
    for (int64_t v0 = t; v0 < nvec; v0 += static_cast<int64_t>(stride) *
                                           kUnroll) {
      float vals[kUnroll][P];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + static_cast<int64_t>(u) * stride;
        if (v < nvec) {
          load16(plane + v * P, vals[u]);
        } else {
#pragma unroll
          for (int j = 0; j < P; ++j) vals[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + static_cast<int64_t>(u) * stride;
        if (v < nvec) f(vals[u], v * P, P);
      }
    }
  } else {
    for (int64_t i = t; i < len; i += stride) {
      float val = to_float(plane[i]);
      f(&val, i, 1);
    }
  }
}

template <typename T, bool kVec, int kCpb>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const Welford* __restrict__ slots,
                    T* __restrict__ y, float* __restrict__ pooled,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int C, int64_t HW, float eps) {
  constexpr int kGroup = kThreads / kCpb;
  __shared__ float pool_scratch[kWarps];
  const int b = blockIdx.y;
  const float2 mr = sample_stats(slots, b, eps);
  const float m = mr.x, rstd = mr.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    mean_out[b] = m;
    rstd_out[b] = rstd;
  }
  const int c = blockIdx.x * kCpb + threadIdx.x / kGroup;
  float acc = 0.0f;
  if (c < C) {
    const float g = gamma[c], bt = beta[c];
    const int64_t off = (static_cast<int64_t>(b) * C + c) * HW;
    T* __restrict__ yp = y + off;
    for_plane<T, kVec>(x + off, HW, threadIdx.x % kGroup, kGroup,
                       [&](const float* v, int64_t i, int cnt) {
                         float out[Vec<T>::kPer];
                         for (int j = 0; j < cnt; ++j) {
                           float xhat;
                           const float z = pre_relu(v[j], m, rstd, g, bt, &xhat);
                           out[j] = fmaxf(z, 0.0f);
                           acc += rd<T>(out[j]);
                         }
                         if (cnt == 1) {
                           yp[i] = from_float<T>(out[0]);
                         } else {
                           store16(yp + i, out);
                         }
                       });
  }
  const float total = group_sum<kGroup>(acc, pool_scratch);
  if (c < C && threadIdx.x % kGroup == 0) {
    pooled[static_cast<int64_t>(b) * C + c] =
        total * (1.0f / static_cast<float>(HW));
  }
}

// Calls f(xhat, gz, i) for this thread's share of channel c of sample b.
template <typename T, bool kVec, int kGroup, typename F>
__device__ __forceinline__ void for_gz(const T* __restrict__ x,
                                       const T* __restrict__ gy, int64_t off,
                                       int64_t HW, float m, float rstd,
                                       float g, float bt, float gp_hw, F&& f) {
  // x and gy are walked together: gy's run at the same offset as x's
  const T* __restrict__ gyp = gy + off;
  for_plane<T, kVec>(x + off, HW, threadIdx.x % kGroup, kGroup,
                     [&](const float* v, int64_t i, int cnt) {
                       float gyv[Vec<T>::kPer];
                       if (cnt == 1) {
                         gyv[0] = to_float(gyp[i]);
                       } else {
                         load16(gyp + i, gyv);
                       }
                       for (int j = 0; j < cnt; ++j) {
                         float xhat;
                         const float z = pre_relu(v[j], m, rstd, g, bt, &xhat);
                         const float gz =
                             z > 0.0f ? rd<T>(gyv[j] + gp_hw) : 0.0f;
                         f(xhat, gz, i + j, j);
                       }
                     });
}

template <typename T, bool kVec, int kCpb>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_sums_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const T* __restrict__ gy, const float* __restrict__ gp,
                       float* __restrict__ dgamma_b,
                       float* __restrict__ dbeta_b, int C, int64_t HW) {
  constexpr int kGroup = kThreads / kCpb;
  __shared__ float scratch_a[kWarps];
  __shared__ float scratch_b[kWarps];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kCpb + threadIdx.x / kGroup;
  float sg = 0.0f, sgx = 0.0f;
  if (c < C) {
    const int64_t bc = static_cast<int64_t>(b) * C + c;
    const float gp_hw = rd<T>(gp[bc] * (1.0f / static_cast<float>(HW)));
    for_gz<T, kVec, kGroup>(x, gy, bc * HW, HW, mean[b], rstd[b], gamma[c],
                            beta[c], gp_hw,
                            [&](float xhat, float gz, int64_t, int) {
                              sg += gz;
                              sgx = fmaf(gz, xhat, sgx);
                            });
  }
  const float tb = group_sum<kGroup>(sg, scratch_a);
  const float tg = group_sum<kGroup>(sgx, scratch_b);
  if (c < C && threadIdx.x % kGroup == 0) {
    dbeta_b[static_cast<int64_t>(b) * C + c] = tb;
    dgamma_b[static_cast<int64_t>(b) * C + c] = tg;
  }
}

template <typename T, bool kVec, int kCpb>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd, const T* __restrict__ gy,
                     const float* __restrict__ gp,
                     const float* __restrict__ dgamma_b,
                     const float* __restrict__ dbeta_b, T* __restrict__ dx,
                     int C, int64_t HW) {
  constexpr int kGroup = kThreads / kCpb;
  __shared__ float2 scratch[kWarps];
  const int b = blockIdx.y;
  // mean(dxhat) and mean(dxhat*xhat) of the sample, from the sums pass
  float a = 0.0f, a2 = 0.0f;
  for (int cc = threadIdx.x; cc < C; cc += kThreads) {
    const int64_t bc = static_cast<int64_t>(b) * C + cc;
    a = fmaf(gamma[cc], dbeta_b[bc], a);
    a2 = fmaf(gamma[cc], dgamma_b[bc], a2);
  }
  const float2 tot = block_sum2<kWarps>(a, a2, scratch);
  const float nf = static_cast<float>(static_cast<int64_t>(C) * HW);
  const float mean_dxhat = tot.x / nf;
  const float mean_dxhat_xhat = tot.y / nf;
  const int c = blockIdx.x * kCpb + threadIdx.x / kGroup;
  if (c >= C) return;  // no barrier follows
  const int64_t bc = static_cast<int64_t>(b) * C + c;
  const float r = rstd[b];
  const float g = gamma[c];
  const float gp_hw = rd<T>(gp[bc] * (1.0f / static_cast<float>(HW)));
  T* __restrict__ dxp = dx + bc * HW;
  float out[Vec<T>::kPer];
  for_gz<T, kVec, kGroup>(
      x, gy, bc * HW, HW, mean[b], r, g, beta[c], gp_hw,
      [&](float xhat, float gz, int64_t i, int j) {
        const float dxhat = gz * g;
        out[j] = r * (dxhat - mean_dxhat - xhat * mean_dxhat_xhat);
        if constexpr (kVec) {
          if (j == Vec<T>::kPer - 1) store16(dxp + i - j, out);
        } else {
          dxp[i] = from_float<T>(out[0]);
        }
      });
}

// ---------------------------------------------------------------------------
// cluster path
// ---------------------------------------------------------------------------

namespace cl {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // chunks of 32 units in flight a warp
constexpr int kTargetCtas = 2 * 132;    // two CTAs on each of the H100's SMs
constexpr int kMaxPortable = 8;         // the rule's largest cluster
constexpr int kMaxLaunch = 16;          // the launch's (non-portable > 8)
// The rule's slice budget lets three CTAs share an SM; a launch takes a
// slice up to what one CTA can hold.
constexpr int64_t kRuleBudget = 72 * 1024;
constexpr int64_t kLaunchBudget = 224 * 1024;
constexpr int64_t kPerChannel = 24;     // gamma, beta, gp/HW, 2 partials
constexpr int kMaxSmem = kLaunchBudget + 2048;   // <= 227 KB

// Byte offsets in dynamic shared memory for CTAs of at most `cn` channels
// of `hw` values of `es` bytes: the same in every CTA of a launch, so that
// a DSMEM address in one CTA names the same slot in another.
struct Layout {
  int gam, bet, gph, slot_a, slot_b, bars, xbar, pairs, scratch, total;
};

__host__ __device__ __forceinline__ int align_up(int64_t v, int a) {
  return static_cast<int>((v + a - 1) / a * a);
}

__host__ __device__ __forceinline__ Layout layout(int cn, int64_t hw,
                                                  int es) {
  Layout L;
  int off = align_up(static_cast<int64_t>(cn) * hw * es, 16);   // the slice
  L.gam = off;
  off += cn * 4;
  L.bet = off;
  off += cn * 4;
  L.gph = off;
  off += cn * 4;
  L.slot_a = off;
  off += (cn + kWarps) * 4;
  L.slot_b = off;
  off += (cn + kWarps) * 4;
  off = align_up(off, 8);
  L.bars = off;
  off += kWarps * 8;
  L.xbar = off;
  off += 8;
  L.pairs = off;
  off += kMaxLaunch * 8;
  L.scratch = off;
  off += kWarps * 8;
  L.total = off;
  return L;
}

__host__ __device__ __forceinline__ int max_channels(int C, int k) {
  return (C + k - 1) / k;
}

bool fits(int C, int64_t HW, int es, int k, int64_t budget) {
  return static_cast<int64_t>(max_channels(C, k)) * (HW * es + kPerChannel) <=
         budget;
}

// The rule (ops/gn.py::gn_path states the same): the cluster size for a
// [B, C, H*W] sample of `es`-byte values, or 0 for the generic path.
// Starting from k0 = min(8, 264/B, C), so that B*k CTAs put two on each SM
// where B allows, the least k up to min(8, C) whose slice fits the budget.
int cluster_k(int B, int C, int64_t HW, int es) {
  const int kmax = C < kMaxPortable ? C : kMaxPortable;
  int k = kTargetCtas / B;
  k = k < 1 ? 1 : k;
  k = k < kmax ? k : kmax;
  for (; k <= kmax; ++k) {
    if (fits(C, HW, es, k, kRuleBudget)) return k;
  }
  return 0;
}

// One unit: 16 bytes (kVec) or one value.
template <typename T, bool kVec>
struct Unit;

template <typename T>
struct Unit<T, true> {
  static constexpr int P = Vec<T>::kPer;
  using Raw = uint4;
  __device__ static Raw load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const Raw& r, float* f) { unpack16<T>(r, f); }
  __device__ static void store(T* p, const float* f) { store16(p, f); }
};

template <typename T>
struct Unit<T, false> {
  static constexpr int P = 1;
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = to_float(r); }
  __device__ static void store(T* p, const float* f) {
    *p = from_float<T>(f[0]);
  }
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives; wait returns once all
// have.  The one use: no CTA stores into a peer's shared memory before the
// peer's exchange mbarrier is initialised.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t remote_u32(const void* local,
                                               uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  return remote;
}

// v into the float2 at `local`'s offset in cluster CTA `rank`'s shared
// memory, its 8 bytes completing on that CTA's mbarrier at `bar`'s offset.
__device__ __forceinline__ void push_remote(float2* local, uint64_t* bar,
                                            uint32_t rank, float2 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(remote_u32(local, rank)),
      "f"(v.x), "f"(v.y), "r"(remote_u32(bar, rank))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this CTA's shared memory, completing on `bar`, which expects
// them.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// returns once `bar`'s phase 0 has completed; acquire at cluster scope, so
// the peers' stores that completed it are seen
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// Inclusive sums of each v[i] over the lanes of each run of equal `key`
// (keys never decrease along the warp): a run's last lane holds its sum.
template <int kN>
__device__ __forceinline__ void seg_scan(float (&v)[kN], int key, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, key, off);
    const bool same = lane >= off && up == key;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float u = __shfl_up_sync(kFull, v[i], off);
      if (same) v[i] += u;
    }
  }
}

// Where a CTA's units are and who walks them: units [0, N) of the slice, V
// a channel; warp w over [lo, hi), 32 consecutive units a chunk, its range
// starting on a multiple of 32 units, so that where V is a multiple of 32
// a chunk lies in one channel.
struct Walk {
  int cn, V, N, lo, hi, warp, lane;
  FastDiv by_v;

  __device__ Walk(int cn_, int HW, int P, FastDiv by_v_) {
    cn = cn_;
    V = HW / P;
    N = cn * V;
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    lo = range(warp);
    hi = range(warp + 1);
    by_v = by_v_;
  }
  __device__ int range(int w) const {
    return w >= kWarps ? N
                       : static_cast<int>(static_cast<int64_t>(w) * N /
                                          kWarps) / 32 * 32;
  }
  // the channel of unit v, or cn past the range (after every channel)
  __device__ int channel(int v) const {
    return v < hi ? quotient(v, by_v) : cn;
  }
};

// One chunk of a warp: its units base .. base+31, the lane's unit and
// channel, and whether all 32 lie in one channel.
struct Chunk {
  int base, v, ch;
  bool uniform;
  __device__ Chunk(int base_, const Walk& w) {
    base = base_;
    v = base + w.lane;
    const int first = w.channel(base), last = w.channel(base + 31);
    uniform = first == last;
    ch = uniform ? first : w.channel(v);
  }
  __device__ bool valid(const Walk& w) const { return v < w.hi; }
};

// Per-(channel, warp) partial sums of kN values over a warp's chunks, each
// in a fixed order.  A chunk in one channel adds to the lane's running sum
// (no shuffles); a mixed chunk is a segmented scan, its inner runs complete
// and its last run left open.  The open partial and the lanes' running sum
// of the same channel join when the channel changes.  Partial (c, w) lands
// at slots[i][c + w]: channels and warp ranges both run along the slice,
// so c + w is unique among the pairs that meet.
template <int kN>
struct Segments {
  float open[kN], run[kN];
  int open_ch = -1, run_ch = -1;   // warp-uniform

  __device__ Segments() {
#pragma unroll
    for (int i = 0; i < kN; ++i) open[i] = run[i] = 0.0f;
  }

  __device__ void close_open(const Walk& w, float* const (&slots)[kN]) {
    if (open_ch >= 0 && w.lane == 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i) slots[i][open_ch + w.warp] = open[i];
    }
    open_ch = -1;
  }

  // the lanes' running sum, reduced over the warp, joins the open partial
  __device__ void close_run(const Walk& w, float* const (&slots)[kN]) {
    if (run_ch < 0) return;
    float r[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      r[i] = run[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        r[i] += __shfl_xor_sync(kFull, r[i], off);
      }
    }
    if (open_ch != run_ch) {
      close_open(w, slots);
#pragma unroll
      for (int i = 0; i < kN; ++i) open[i] = r[i];
      open_ch = run_ch;
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) open[i] += r[i];
    }
    run_ch = -1;
  }

  __device__ void add(float (&acc)[kN], const Chunk& c, const Walk& w,
                      float* const (&slots)[kN]) {
    if (c.uniform) {
      if (c.ch != run_ch) {
        close_run(w, slots);
        run_ch = c.ch;
#pragma unroll
        for (int i = 0; i < kN; ++i) run[i] = acc[i];
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) run[i] += acc[i];
      }
      return;
    }
    close_run(w, slots);
    const int first = __shfl_sync(kFull, c.ch, 0);
    if (first != open_ch) close_open(w, slots);
    if (open_ch >= 0 && w.lane == 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = open[i] + acc[i];
    }
    seg_scan<kN>(acc, c.ch, w.lane);
    // the last valid lane's run stays open; every earlier run is complete
    const int last = min(31, w.hi - 1 - c.base);
    const int next = __shfl_down_sync(kFull, c.ch, 1);
    if (w.lane < last && next != c.ch) {
#pragma unroll
      for (int i = 0; i < kN; ++i) slots[i][c.ch + w.warp] = acc[i];
    }
    open_ch = __shfl_sync(kFull, c.ch, last);
#pragma unroll
    for (int i = 0; i < kN; ++i) open[i] = __shfl_sync(kFull, acc[i], last);
  }

  // after the warp's last chunk
  __device__ void finish(const Walk& w, float* const (&slots)[kN]) {
    close_run(w, slots);
    close_open(w, slots);
  }
};

// Channel c's total over the warps whose ranges meet it, in warp order.
__device__ __forceinline__ float channel_total(const float* slots, int c,
                                               const Walk& w) {
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int lo = w.range(i), hi = w.range(i + 1);
    if (lo < hi && lo < (c + 1) * w.V && hi > c * w.V) t += slots[c + i];
  }
  return t;
}

// The sample's sums over the cluster.  At the kernel's start thread 0
// readies this CTA's exchange mbarrier for k pairs and every thread
// arrives on the cluster barrier; exchange() waits on that barrier (every
// peer's mbarrier is then ready), has warp 0 store this CTA's pair into
// slot `rank` of each CTA of the cluster, waits for the k pairs here, and
// sums them in rank order: every CTA gets the same bits.  No CTA reads
// another's shared memory, and each waits for every store into its own,
// so none may leave early.
__device__ __forceinline__ void exchange_start(uint64_t* xbar, int k) {
  if (threadIdx.x == 0) {
    mbar_init(xbar);
    mbar_expect(xbar, static_cast<uint32_t>(k) * 8);
  }
  cluster_arrive();
}

__device__ __forceinline__ float2 exchange(float2 own, float2* pairs,
                                           uint64_t* xbar, int k, int rank,
                                           const Walk& w) {
  cluster_wait();
  if (w.warp == 0 && w.lane < k) push_remote(pairs + rank, xbar, w.lane, own);
  mbar_wait0(xbar);
  float s = 0.0f, q = 0.0f;
  for (int r = 0; r < k; ++r) {
    s += pairs[r].x;
    q += pairs[r].y;
  }
  return make_float2(s, q);
}

// The warp's share of the slice into shared memory: a bulk copy onto the
// warp's mbarrier (kVec; finish_load waits for it) or plain loads.
template <typename T, bool kVec>
__device__ __forceinline__ void start_load(T* sx, const T* xs, const Walk& w,
                                           uint64_t* bar) {
  if constexpr (kVec) {
    if (w.hi > w.lo) {
      if (w.lane == 0) mbar_init(bar);
      __syncwarp();
      if (w.lane == 0) {
        constexpr int P = Unit<T, true>::P;
        const int64_t at = static_cast<int64_t>(w.lo) * P;
        const uint32_t bytes = static_cast<uint32_t>(w.hi - w.lo) * 16;
        mbar_expect(bar, bytes);
        bulk_copy(sx + at, xs + at, bytes, bar);
      }
    }
  } else {
    for (int v0 = w.lo + w.lane; v0 < w.hi; v0 += 32 * kUnroll) {
      T raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < w.hi) raw[u] = xs[v];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < w.hi) sx[v] = raw[u];
      }
    }
    __syncwarp();
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void finish_load(const Walk& w, uint64_t* bar) {
  if constexpr (kVec) {
    if (w.hi > w.lo) mbar_wait0(bar);
  }
}

// CTA `rank` of sample b: channels [c_lo, c_lo + cn)
struct Slice {
  int b, rank, c_lo, cn, cn_max;
  __device__ Slice(int C, int k) {
    rank = static_cast<int>(cluster_rank());
    b = blockIdx.x / k;
    c_lo = static_cast<int>(static_cast<int64_t>(rank) * C / k);
    const int c_hi = static_cast<int>(static_cast<int64_t>(rank + 1) * C / k);
    cn = c_hi - c_lo;
    cn_max = max_channels(C, k);
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    gn_bwd_cluster_kernel(const T* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const T* __restrict__ gy,
                          const float* __restrict__ gp, T* __restrict__ dx,
                          float* __restrict__ dgamma_b,
                          float* __restrict__ dbeta_b, int C, int HW, int k,
                          FastDiv by_v) {
  using U = Unit<T, kVec>;
  using Raw = typename U::Raw;
  constexpr int P = U::P;
  extern __shared__ __align__(128) unsigned char smem[];
  const Slice sl(C, k);
  const Layout L = layout(sl.cn_max, HW, sizeof(T));
  T* sx = reinterpret_cast<T*>(smem);
  float* sgam = reinterpret_cast<float*>(smem + L.gam);
  float* sbet = reinterpret_cast<float*>(smem + L.bet);
  float* sgph = reinterpret_cast<float*>(smem + L.gph);
  float* slot_b = reinterpret_cast<float*>(smem + L.slot_a);   // dbeta
  float* slot_g = reinterpret_cast<float*>(smem + L.slot_b);   // dgamma
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.xbar);
  float2* pairs = reinterpret_cast<float2*>(smem + L.pairs);
  float2* scratch = reinterpret_cast<float2*>(smem + L.scratch);
  const Walk w(sl.cn, HW, P, by_v);
  const int64_t off = (static_cast<int64_t>(sl.b) * C + sl.c_lo) * HW;
  const T* __restrict__ gys = gy + off;

  start_load<T, kVec>(sx, x + off, w, bars + w.warp);
  exchange_start(xbar, k);
  const float inv_hw = 1.0f / static_cast<float>(HW);
  for (int i = threadIdx.x; i < sl.cn; i += kThreads) {
    const int c = sl.c_lo + i;
    sgam[i] = gamma[c];
    sbet[i] = beta[c];
    sgph[i] = rd<T>(gp[static_cast<int64_t>(sl.b) * C + c] * inv_hw);
  }
  __syncthreads();
  const float m = mean[sl.b], r = rstd[sl.b];

  // f(j, xhat, gz) for each value of the lane's unit (valid) of chunk ck,
  // given its raw x and gy
  auto for_gz = [&](const Chunk& ck, const Raw& xr, const Raw& gr,
                    auto&& f) {
    float xv[P], gv[P];
    U::unpack(xr, xv);
    U::unpack(gr, gv);
    const float g = sgam[ck.ch], bt = sbet[ck.ch], gph = sgph[ck.ch];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float xhat;
      const float z = pre_relu(xv[j], m, r, g, bt, &xhat);
      f(j, xhat, z > 0.0f ? rd<T>(gv[j] + gph) : 0.0f);
    }
  };
  // the warp's chunks, chunk(ck, x raw, gy raw) for each: kUnroll of gy's
  // units (from global memory) and x's (from shared memory) loaded before
  // any is used
  auto for_chunks = [&](auto&& chunk) {
    for (int b0 = w.lo; b0 < w.hi; b0 += 32 * kUnroll) {
      Raw g_raw[kUnroll], x_raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = b0 + 32 * u + w.lane;
        g_raw[u] = v < w.hi ? U::load(gys + static_cast<int64_t>(v) * P)
                            : Raw{};
      }
      finish_load<T, kVec>(w, bars + w.warp);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = b0 + 32 * u + w.lane;
        x_raw[u] = v < w.hi ? U::load(sx + static_cast<int64_t>(v) * P)
                            : Raw{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + 32 * u < w.hi) {
          chunk(Chunk(b0 + 32 * u, w), x_raw[u], g_raw[u]);
        }
      }
    }
  };

  // pass 1: per channel, sum gz and gz*xhat
  Segments<2> seg;
  float* const slots[2] = {slot_b, slot_g};
  for_chunks([&](const Chunk& ck, const Raw& xr, const Raw& gr) {
    float acc[2] = {0.0f, 0.0f};
    if (ck.valid(w)) {
      for_gz(ck, xr, gr, [&](int, float xhat, float gz) {
        acc[0] += gz;
        acc[1] = fmaf(gz, xhat, acc[1]);
      });
    }
    seg.add(acc, ck, w, slots);
  });
  seg.finish(w, slots);
  __syncthreads();
  float a = 0.0f, a2 = 0.0f;
  for (int c = threadIdx.x; c < sl.cn; c += kThreads) {
    const float tb = channel_total(slot_b, c, w);
    const float tg = channel_total(slot_g, c, w);
    const int64_t bc = static_cast<int64_t>(sl.b) * C + sl.c_lo + c;
    dbeta_b[bc] = tb;
    dgamma_b[bc] = tg;
    a = fmaf(sgam[c], tb, a);
    a2 = fmaf(sgam[c], tg, a2);
  }
  const float2 tot = exchange(block_sum2<kWarps>(a, a2, scratch), pairs, xbar,
                              k, sl.rank, w);
  const float nf = static_cast<float>(static_cast<int64_t>(C) * HW);
  const float mean_dxhat = tot.x / nf, mean_dxhat_xhat = tot.y / nf;

  // pass 2: dx, gy read again (from L2)
  T* __restrict__ dxs = dx + off;
  for_chunks([&](const Chunk& ck, const Raw& xr, const Raw& gr) {
    if (!ck.valid(w)) return;
    const float g = sgam[ck.ch];
    float out[P];
    for_gz(ck, xr, gr, [&](int j, float xhat, float gz) {
      const float dxhat = gz * g;
      out[j] = r * (dxhat - mean_dxhat - xhat * mean_dxhat_xhat);
    });
    U::store(dxs + static_cast<int64_t>(ck.v) * P, out);
  });
}

}  // namespace cl

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
bool aligned16(const void* p, int64_t len) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         len % Vec<T>::kPer == 0;
}

// The forward's statistics pass: each sample's Welford slots.
template <typename T>
cudaError_t launch_stats(const void* x, Welford* slots, int B, int64_t n,
                         cudaStream_t st) {
  gn_stats_kernel<T><<<dim3(kChains / kThreads, B), kThreads, 0, st>>>(
      static_cast<const T*>(x), n, slots);
  return cudaGetLastError();
}

template <typename T, bool kVec, int kCpb>
void launch_apply(const void* x, const float* gamma, const float* beta,
                  const Welford* slots, void* y, float* pooled, float* mean,
                  float* rstd, int B, int C, int64_t HW, float eps,
                  cudaStream_t st) {
  const dim3 grid((C + kCpb - 1) / kCpb, B);
  gn_apply_kernel<T, kVec, kCpb><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), gamma, beta, slots, static_cast<T*>(y),
      pooled, mean, rstd, C, HW, eps);
}

template <typename T>
cudaError_t forward(const void* x, const float* gamma, const float* beta,
                    void* y, float* pooled, float* mean, float* rstd,
                    Welford* slots, int B, int C, int64_t HW, float eps,
                    cudaStream_t st) {
  cudaError_t err = launch_stats<T>(x, slots, B, C * HW, st);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16<T>(x, HW) && aligned16<T>(y, HW);
  const bool whole = HW >= kWholeBlockHW;
  if (vec && whole) {
    launch_apply<T, true, 1>(x, gamma, beta, slots, y, pooled, mean, rstd, B,
                             C, HW, eps, st);
  } else if (vec) {
    launch_apply<T, true, kWarps>(x, gamma, beta, slots, y, pooled, mean,
                                  rstd, B, C, HW, eps, st);
  } else if (whole) {
    launch_apply<T, false, 1>(x, gamma, beta, slots, y, pooled, mean, rstd,
                              B, C, HW, eps, st);
  } else {
    launch_apply<T, false, kWarps>(x, gamma, beta, slots, y, pooled, mean,
                                   rstd, B, C, HW, eps, st);
  }
  return cudaGetLastError();
}

template <typename T, bool kVec, int kCpb>
cudaError_t backward_as(const void* x, const float* gamma, const float* beta,
                        const float* mean, const float* rstd, const void* gy,
                        const float* gp, void* dx, float* dgamma_b,
                        float* dbeta_b, int B, int C, int64_t HW,
                        cudaStream_t st) {
  const dim3 grid((C + kCpb - 1) / kCpb, B);
  const T* xt = static_cast<const T*>(x);
  const T* gyt = static_cast<const T*>(gy);
  gn_bwd_sums_kernel<T, kVec, kCpb><<<grid, kThreads, 0, st>>>(
      xt, gamma, beta, mean, rstd, gyt, gp, dgamma_b, dbeta_b, C, HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_dx_kernel<T, kVec, kCpb><<<grid, kThreads, 0, st>>>(
      xt, gamma, beta, mean, rstd, gyt, gp, dgamma_b, dbeta_b,
      static_cast<T*>(dx), C, HW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const float* gamma, const float* beta,
                     const float* mean, const float* rstd, const void* gy,
                     const float* gp, void* dx, float* dgamma_b,
                     float* dbeta_b, int B, int C, int64_t HW,
                     cudaStream_t st) {
  const bool vec = aligned16<T>(x, HW) && aligned16<T>(gy, HW) &&
                   aligned16<T>(dx, HW);
  const bool whole = HW >= kWholeBlockHW;
  if (vec && whole) {
    return backward_as<T, true, 1>(x, gamma, beta, mean, rstd, gy, gp, dx,
                                   dgamma_b, dbeta_b, B, C, HW, st);
  }
  if (vec) {
    return backward_as<T, true, kWarps>(x, gamma, beta, mean, rstd, gy, gp,
                                        dx, dgamma_b, dbeta_b, B, C, HW, st);
  }
  if (whole) {
    return backward_as<T, false, 1>(x, gamma, beta, mean, rstd, gy, gp, dx,
                                    dgamma_b, dbeta_b, B, C, HW, st);
  }
  return backward_as<T, false, kWarps>(x, gamma, beta, mean, rstd, gy, gp, dx,
                                       dgamma_b, dbeta_b, B, C, HW, st);
}

// Sets, once per kernel and device, the largest dynamic shared memory a
// cluster launch asks for and leave to take clusters above 8 CTAs.
cudaError_t configure(const void* kernel, int device) {
  struct Entry {
    const void* kernel;
    int device;
  };
  static std::mutex mu;
  static Entry done[32];
  static int n = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    if (done[i].kernel == kernel && done[i].device == device) {
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cl::kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (n < 32) done[n++] = {kernel, device};
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int B, int k, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
  cfg.blockDim = dim3(cl::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster path takes k in [1, 16], k <= C, and a slice within budget.
bool cluster_ok(int B, int C, int64_t HW, int es, int k) {
  return k >= 1 && k <= cl::kMaxLaunch && k <= C &&
         static_cast<int64_t>(B) * k <= INT32_MAX &&
         cl::fits(C, HW, es, k, cl::kLaunchBudget) &&
         cl::layout(cl::max_channels(C, k), HW, es).total <= cl::kMaxSmem;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int B, int C, int64_t HW, int es,
                           int k, cudaStream_t st, int device,
                           Args... args) {
  cudaError_t err = configure(reinterpret_cast<const void*>(kernel), device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const int smem = cl::layout(cl::max_channels(C, k), HW, es).total;
  const cudaLaunchConfig_t cfg = cluster_config(B, k, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_cluster(const void* x, const float* gamma,
                             const float* beta, const float* mean,
                             const float* rstd, const void* gy,
                             const float* gp, void* dx, float* dgamma_b,
                             float* dbeta_b, int B, int C, int HW, int k,
                             cudaStream_t st, int device) {
  const bool vec = aligned16<T>(x, HW) && aligned16<T>(gy, HW) &&
                   aligned16<T>(dx, HW);
  const T* xt = static_cast<const T*>(x);
  const T* gyt = static_cast<const T*>(gy);
  T* dxt = static_cast<T*>(dx);
  const cl::FastDiv by_v = cl::make_div(vec ? HW / Vec<T>::kPer : HW);
  if (vec) {
    return launch_cluster(cl::gn_bwd_cluster_kernel<T, true>, B, C, HW,
                          sizeof(T), k, st, device, xt, gamma, beta, mean,
                          rstd, gyt, gp, dxt, dgamma_b, dbeta_b, C, HW, k,
                          by_v);
  }
  return launch_cluster(cl::gn_bwd_cluster_kernel<T, false>, B, C, HW,
                        sizeof(T), k, st, device, xt, gamma, beta, mean, rstd,
                        gyt, gp, dxt, dgamma_b, dbeta_b, C, HW, k, by_v);
}

bool shape_ok(int B, int C, int H, int W) {
  return B > 0 && C > 0 && H > 0 && W > 0;
}

// where the forward's Welford slots start in its buffer
int64_t partial_offset(int B, int C) {
  return (static_cast<int64_t>(B) * C + 2 * static_cast<int64_t>(B) + 3) / 4 *
         4;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `stats` is one fp32 buffer:
// pooled [B, C], then m [B] and rstd [B], then from partial_offset(B, C)
// the statistics pass's B*kSlots Welford slots (3 floats each).  Every
// shape takes the statistics pass and the apply pass.
extern "C" int betavae_gn_fwd(const void* x, const float* gamma,
                              const float* beta, void* y, float* stats,
                              int B, int C, int H, int W, float eps,
                              int dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, C, H, W) || B > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t HW = static_cast<int64_t>(H) * W;
  float* pooled = stats;
  float* mean = stats + static_cast<int64_t>(B) * C;
  float* rstd = mean + B;
  Welford* slots = reinterpret_cast<Welford*>(stats + partial_offset(B, C));
  err = dtype == 1
            ? forward<__nv_bfloat16>(x, gamma, beta, y, pooled, mean, rstd,
                                     slots, B, C, HW, eps, st)
            : forward<float>(x, gamma, beta, y, pooled, mean, rstd, slots, B,
                             C, HW, eps, st);
  return static_cast<int>(err);
}

// `dparams` is one fp32 buffer: dgamma [B, C] then dbeta [B, C].  k > 0
// takes the cluster path with clusters of k CTAs (above 8 a non-portable
// size); k = 0 the generic path.
extern "C" int betavae_gn_bwd(const void* x, const float* gamma,
                              const float* beta, const float* mean,
                              const float* rstd, const void* gy,
                              const float* gp, void* dx, float* dparams,
                              int B, int C, int H, int W, int dtype, int k,
                              void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, C, H, W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int es = dtype == 1 ? 2 : 4;
  float* dgamma_b = dparams;
  float* dbeta_b = dparams + static_cast<int64_t>(B) * C;
  if (k > 0) {
    if (!cluster_ok(B, C, HW, es, k)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int hw = static_cast<int>(HW);
    err = dtype == 1
              ? backward_cluster<__nv_bfloat16>(x, gamma, beta, mean, rstd, gy,
                                                gp, dx, dgamma_b, dbeta_b, B,
                                                C, hw, k, st, device)
              : backward_cluster<float>(x, gamma, beta, mean, rstd, gy, gp, dx,
                                        dgamma_b, dbeta_b, B, C, hw, k, st,
                                        device);
    return static_cast<int>(err);
  }
  if (k < 0 || B > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  err = dtype == 1
            ? backward<__nv_bfloat16>(x, gamma, beta, mean, rstd, gy, gp, dx,
                                      dgamma_b, dbeta_b, B, C, HW, st)
            : backward<float>(x, gamma, beta, mean, rstd, gy, gp, dx,
                              dgamma_b, dbeta_b, B, C, HW, st);
  return static_cast<int>(err);
}

// The path rule (ops/gn.py::gn_path states the same): k > 0 for clusters
// of k CTAs, or -1 for the generic path; 0 for a shape or dtype the kernels
// do not take.
extern "C" int betavae_gn_path(int B, int C, int H, int W, int dtype) {
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, C, H, W)) return 0;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int k = cl::cluster_k(B, C, HW, dtype == 1 ? 2 : 4);
  return k > 0 ? k : -1;
}

// How many clusters of k CTAs of the backward kernel the device holds at
// once for this shape (16-byte path), from cudaOccupancyMaxActiveClusters;
// a negative cudaError_t on failure.
extern "C" int betavae_gn_active_clusters(int B, int C, int H, int W,
                                          int dtype, int k, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int es = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, C, H, W) ||
      !cluster_ok(B, C, HW, es, k)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel =
      dtype == 1
          ? reinterpret_cast<const void*>(
                cl::gn_bwd_cluster_kernel<__nv_bfloat16, true>)
          : reinterpret_cast<const void*>(cl::gn_bwd_cluster_kernel<float, true>);
  err = configure(kernel, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const int smem = cl::layout(cl::max_channels(C, k), HW, es).total;
  const cudaLaunchConfig_t cfg = cluster_config(B, k, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
