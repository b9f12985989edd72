// GroupNorm with one group -> ReLU -> per-channel spatial mean (the SE
// squeeze), forward and backward.
//
// Replaces the Pallas TPU kernels of betavae_tpu/ops/pallas_gn.py:
//
//   _fwd_kernel (launched by _run_fwd, pallas_call at pallas_gn.py:123;
//                _run_fwd at :113), per sample b over all C*H*W values:
//       m = sum(x)/n,  v = sum(x*x)/n - m*m,  rstd = rsqrt(max(v, 0) + eps)
//       xhat = (x - m)*rstd,  z = xhat*gamma[c] + beta[c],  y = max(z, 0)
//       pooled[b,c] = mean_hw(y)   (of the fp32 y, before y is rounded)
//   _bwd_kernel (launched by _run_bwd, pallas_call at pallas_gn.py:149;
//                _run_bwd at :139), given gy = dL/dy and gp = dL/dpooled:
//       gz = (gy + gp[b,c]/HW) * 1[z > 0]
//       dbeta[b,c] = sum_hw gz,  dgamma[b,c] = sum_hw gz*xhat
//       dxhat = gz*gamma[c]
//       dx = rstd*(dxhat - mean(dxhat) - xhat*mean(dxhat*xhat))
//
// x, y, gy and dx are NCHW in bf16 or fp32; gamma, beta [C], gp, pooled,
// dgamma and dbeta [B, C] and m, rstd [B] are fp32, and every sum and
// product is fp32.  The per-sample partials dgamma and dbeta are summed
// over B by the caller, as the JAX package's _gn_bwd does.
//
// Bound on an H100 SXM (3.35 TB/s HBM; 67 TFLOP/s fp32 outside the tensor
// cores), counting each input read once and each output written once:
//   forward:  read x, write y: 2|x|.  At the flagship's largest block,
//             bf16 [32, 64, 128, 128] (|x| = 67.1 MB), 0.040 ms.
//   backward: read x and gy, write dx: 3|x|, 0.060 ms at the same shape.
// About 9 fp32 operations per value forward and 16 backward, under 9 per
// byte of bf16: far below the ~20 per byte where the arithmetic would
// limit.  Both are bound by bytes.
//
// Design (the TPU kernel holds one whole sample in VMEM per sequential grid
// step; a Hopper block has 227 KB of shared memory, and one sample at the
// flagship's largest block is 2 MiB of bf16, so each per-sample reduction
// spans several blocks, in separate passes, with no atomics):
//   forward, two kernels:
//     gn_stats: grid (splits, B); each block sums x and x*x over one
//       contiguous chunk of its sample and writes the fp32 pair.
//     gn_apply: grid (ceil(C/cpb), B); each block sums its sample's pairs
//       in one fixed order (every block of the sample gets the same bits),
//       forms m and rstd, and walks its channels' H*W planes (contiguous in
//       NCHW), writing y and the channel's pooled mean; the sample's first
//       block writes m and rstd.
//   backward, two kernels:
//     gn_bwd_sums: the same grid; per channel, sum_hw gz and gz*xhat give
//       dbeta and dgamma.
//     gn_bwd_dx: the same grid; the per-sample means need no third
//       reduction over the sample: sum dxhat = sum_c gamma_c*dbeta[b,c] and
//       sum dxhat*xhat = sum_c gamma_c*dgamma[b,c].  Each block sums those
//       over C in one fixed order, then writes dx.
//   Channels per block (cpb): a plane of at least kWholeBlockHW values gets
//   the whole block of 256 threads; smaller planes get one warp each, 8
//   channels a block.  Every sum is per thread in order, then a warp
//   shuffle, then across warps in index order: the same input gives the
//   same bits every run.
//   z is formed with separately rounded operations, (x - m)*rstd*gamma +
//   beta, as torch's elementwise ops form it, so that the ReLU mask of the
//   plain version given the same m and rstd is the kernel's, bit for bit.
//   The two passes over x move 3|x| forward and 5|x| backward unless L2
//   (50 MB) still holds x from the first pass.
//   Values are read and written 16 bytes a thread where the rows allow it
//   (the tensor 16-byte aligned and H*W a multiple of 8 bf16 or 4 fp32),
//   else one value a thread; offsets are 64-bit.
//
// C interface, for ctypes: each entry point returns the cudaError_t of its
// launches (0 on success), or cudaErrorInvalidValue for a dtype code or
// shape it does not take.  The caller allocates every buffer (the forward's
// stats scratch too: B*splits float2) and passes its current stream;
// nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int64_t kWholeBlockHW = 4096;    // planes this large: cpb = 1
constexpr int kMaxGridY = 65535;

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

// kPer values of T in one 16-byte load or store, as fp32.
template <typename T>
struct Vec {
  static constexpr int kPer = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// a bf16 is the top half of its fp32; element 0 is the low half of word 0
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
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
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// (a, b) summed over the block in a fixed order, returned to every thread.
// `scratch` holds kWarps float2 and is used by this call only.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total.x += scratch[w].x;
    total.y += scratch[w].y;
  }
  return total;
}

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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial,
                    int64_t n, int64_t chunk) {
  __shared__ float2 scratch[kWarps];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t lo = min(static_cast<int64_t>(s) * chunk, n);
  const int64_t hi = min(lo + chunk, n);
  float sum = 0.0f, sq = 0.0f;
  for_plane<T, kVec>(x + static_cast<int64_t>(b) * n + lo, hi - lo,
                     threadIdx.x, kThreads,
                     [&](const float* v, int64_t, int cnt) {
                       for (int j = 0; j < cnt; ++j) {
                         sum += v[j];
                         sq = fmaf(v[j], v[j], sq);
                       }
                     });
  const float2 total = block_sum2(sum, sq, scratch);
  if (threadIdx.x == 0) partial[static_cast<int64_t>(b) * gridDim.x + s] = total;
}

// m and rstd of sample b from its `splits` stats pairs, in one fixed order.
__device__ __forceinline__ float2 sample_stats(const float2* __restrict__ partial,
                                               int b, int splits, float nf,
                                               float eps, float2* scratch) {
  float s = 0.0f, q = 0.0f;
  for (int i = threadIdx.x; i < splits; i += kThreads) {
    const float2 p = partial[static_cast<int64_t>(b) * splits + i];
    s += p.x;
    q += p.y;
  }
  const float2 tot = block_sum2(s, q, scratch);
  const float m = tot.x / nf;
  const float v = tot.y / nf - m * m;
  return make_float2(m, rsqrtf(fmaxf(v, 0.0f) + eps));
}

// z = (x - m)*rstd*gamma + beta, each operation rounded on its own (no fma),
// as the plain version's elementwise torch ops round it.
__device__ __forceinline__ float pre_relu(float x, float m, float rstd,
                                          float g, float bt, float* xhat) {
  *xhat = __fmul_rn(__fsub_rn(x, m), rstd);
  return __fadd_rn(__fmul_rn(*xhat, g), bt);
}

template <typename T, bool kVec, int kCpb>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float2* __restrict__ partial, int splits,
                    T* __restrict__ y, float* __restrict__ pooled,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int C, int64_t HW, float eps) {
  constexpr int kGroup = kThreads / kCpb;
  __shared__ float2 stats_scratch[kWarps];
  __shared__ float pool_scratch[kWarps];
  const int b = blockIdx.y;
  const float nf = static_cast<float>(static_cast<int64_t>(C) * HW);
  const float2 mr = sample_stats(partial, b, splits, nf, eps, stats_scratch);
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
                           acc += out[j];
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

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
                         const float gz = z > 0.0f ? gyv[j] + gp_hw : 0.0f;
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
    const float gp_hw = gp[bc] * (1.0f / static_cast<float>(HW));
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
  const float2 tot = block_sum2(a, a2, scratch);
  const float nf = static_cast<float>(static_cast<int64_t>(C) * HW);
  const float mean_dxhat = tot.x / nf;
  const float mean_dxhat_xhat = tot.y / nf;
  const int c = blockIdx.x * kCpb + threadIdx.x / kGroup;
  if (c >= C) return;  // no barrier follows
  const int64_t bc = static_cast<int64_t>(b) * C + c;
  const float r = rstd[b];
  const float g = gamma[c];
  const float gp_hw = gp[bc] * (1.0f / static_cast<float>(HW));
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
// launch
// ---------------------------------------------------------------------------

template <typename T>
bool aligned16(const void* p, int64_t len) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         len % Vec<T>::kPer == 0;
}

template <typename T, bool kVec, int kCpb>
void launch_apply(const void* x, const float* gamma, const float* beta,
                  const float2* partial, int splits, void* y, float* pooled,
                  float* mean, float* rstd, int B, int C, int64_t HW,
                  float eps, cudaStream_t st) {
  const dim3 grid((C + kCpb - 1) / kCpb, B);
  gn_apply_kernel<T, kVec, kCpb><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), gamma, beta, partial, splits,
      static_cast<T*>(y), pooled, mean, rstd, C, HW, eps);
}

template <typename T>
cudaError_t forward(const void* x, const float* gamma, const float* beta,
                    void* y, float* pooled, float* mean, float* rstd,
                    float2* partial, int splits, int B, int C, int64_t HW,
                    float eps, cudaStream_t st) {
  constexpr int P = Vec<T>::kPer;
  const int64_t n = static_cast<int64_t>(C) * HW;
  // chunks of a multiple of P values, so every chunk of an aligned sample
  // starts on a 16-byte boundary
  int64_t chunk = (n + splits - 1) / splits;
  chunk = (chunk + P - 1) / P * P;
  const dim3 sgrid(splits, B);
  if (aligned16<T>(x, n)) {
    gn_stats_kernel<T, true><<<sgrid, kThreads, 0, st>>>(
        static_cast<const T*>(x), partial, n, chunk);
  } else {
    gn_stats_kernel<T, false><<<sgrid, kThreads, 0, st>>>(
        static_cast<const T*>(x), partial, n, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = aligned16<T>(x, HW) && aligned16<T>(y, HW);
  const bool whole = HW >= kWholeBlockHW;
  if (vec && whole) {
    launch_apply<T, true, 1>(x, gamma, beta, partial, splits, y, pooled, mean,
                             rstd, B, C, HW, eps, st);
  } else if (vec) {
    launch_apply<T, true, kWarps>(x, gamma, beta, partial, splits, y, pooled,
                                  mean, rstd, B, C, HW, eps, st);
  } else if (whole) {
    launch_apply<T, false, 1>(x, gamma, beta, partial, splits, y, pooled,
                              mean, rstd, B, C, HW, eps, st);
  } else {
    launch_apply<T, false, kWarps>(x, gamma, beta, partial, splits, y, pooled,
                                   mean, rstd, B, C, HW, eps, st);
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

bool shape_ok(int B, int C, int H, int W) {
  return B > 0 && C > 0 && H > 0 && W > 0 && B <= kMaxGridY;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `partial` is the stats scratch
// of B*splits float2, splits in [1, 65535].
extern "C" int betavae_gn_fwd(const void* x, const float* gamma,
                              const float* beta, void* y, float* pooled,
                              float* mean, float* rstd, void* partial,
                              int splits, int B, int C, int H, int W,
                              float eps, int dtype, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, C, H, W) || splits < 1 ||
      splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t HW = static_cast<int64_t>(H) * W;
  float2* part = static_cast<float2*>(partial);
  err = dtype == 1
            ? forward<__nv_bfloat16>(x, gamma, beta, y, pooled, mean, rstd,
                                     part, splits, B, C, HW, eps, st)
            : forward<float>(x, gamma, beta, y, pooled, mean, rstd, part,
                             splits, B, C, HW, eps, st);
  return static_cast<int>(err);
}

extern "C" int betavae_gn_bwd(const void* x, const float* gamma,
                              const float* beta, const float* mean,
                              const float* rstd, const void* gy,
                              const float* gp, void* dx, float* dgamma_b,
                              float* dbeta_b, int B, int C, int H, int W,
                              int dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, C, H, W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t HW = static_cast<int64_t>(H) * W;
  err = dtype == 1
            ? backward<__nv_bfloat16>(x, gamma, beta, mean, rstd, gy, gp, dx,
                                      dgamma_b, dbeta_b, B, C, HW, st)
            : backward<float>(x, gamma, beta, mean, rstd, gy, gp, dx,
                              dgamma_b, dbeta_b, B, C, HW, st);
  return static_cast<int>(err);
}
