// Fused reparameterisation sample + elementwise KL for the β-VAE latent, and
// its backward.
//
// Forward: replaces the Pallas TPU kernel betavae_tpu/ops/pallas_elbo.py::
// _kernel (launched by _run_kernel, pallas_call at pallas_elbo.py:79).  One
// pass over fp32 mu and logvar of n elements writes one [3, n] buffer:
//
//     z   = mu + eps * exp(logvar / 2)                      (row 0)
//     kl  = -(1 + logvar - mu^2 - exp(logvar)) / 2          (row 1)
//     eps ~ N(0, 1), generated here, never read             (row 2)
//
// Backward: the counterpart of the JAX custom VJP pallas_elbo.py:118-125,
// which XLA fuses into one pass on the TPU.  One pass over mu, logvar, eps
// and the two incoming gradients (read through their strides, so that a
// broadcast gradient needs no copy) writes one [2, n] buffer:
//
//     dmu     = g_z + g_kl * mu                                       (row 0)
//     dlogvar = eps/2 * exp(logvar/2) * g_z + (exp(logvar) - 1)/2 * g_kl (row 1)
//
// Noise: Philox4x32-10 keyed by the 64-bit seed, with the 128-bit counter
// (start + element index, offset), so each element's draw is independent of
// the launch shape and a (seed, offset) pair replays bitwise.  `start` is
// the flat index of the launch's first element in a larger tensor: a
// data-parallel rank holding rows [r*b, (r+1)*b) of a [B, D] batch passes
// start = r*b*D and draws exactly those rows of the whole batch's noise.
// Box-Muller on the top 24 bits of two words, u1 clamped at 1e-7, the cosine
// branch only: the transform of pallas_elbo.py:49-60.  The TPU kernel uses the TPU's own
// PRNG, so the streams differ by design; the distribution is the same.
//
// What bounds it on an H100.  At the flagship's [32, 64] (2048 elements, 8
// CTAs) the forward moves 40 KB (2 arrays read, 3 written) and the backward
// 56 KB (5 read, 2 written): 12 and 17 ns of HBM time at 3.35 TB/s.  The
// arithmetic (10 Philox rounds, log, sqrt, cos, two exp a value) is a few
// hundred operations an element, nanoseconds at that size.  What a call
// costs is the launch: microseconds of the host issuing it and of the card
// starting a grid after the previous one drains.  No layout or tiling
// reaches half the byte bound at 2048 elements, so the design works on the
// launch, not on the bytes:
//
// - Programmatic dependent launch.  Both kernels can be launched with
//   cudaLaunchAttributeProgrammaticStreamSerialization, so the card may
//   start them while the kernel before them still runs.  Each reads its
//   inputs, and writes anything, only after griddepcontrol.wait, which
//   returns once the previous grid has finished and its writes are visible;
//   once its loads are issued it lets a dependent launch start
//   (griddepcontrol.launch_dependents).  The backward is launched with it;
//   the forward without it, the faster of the two in a replayed CUDA graph
//   (ops/elbo.py::FORWARD_PDL).
// - The fused backward replaces the dozen elementwise PyTorch launches of
//   the closed form with one.
// - The host side of a call: one output buffer per direction, the caller's
//   stream passed in, no per-call cudaSetDevice (the stream names the
//   device).
//
// z, kl and both gradients use explicitly rounded operations (__fmul_rn
// etc.) in the order of the plain PyTorch versions, so that no multiply-add
// is fused: they round exactly like them given the same eps, which lets the
// checks against them be tight.
//
// The offset is read from device memory (*offset_at, an int64), after the
// wait, so a launch captured in a CUDA graph draws the noise of whatever
// step index the graph wrote there before it: a replay is not pinned to the
// capture's offset.
//
// C interface, for ctypes: each entry returns the cudaError_t of the launch
// (0 on success).  The caller allocates every buffer and passes its current
// stream; nothing here allocates or synchronises.  `pdl` 1 launches with
// the attribute, 0 without it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// eps of element i: Box-Muller (cosine branch) on words 0 and 1
__device__ __forceinline__ float normal_at(int64_t i, uint2 key,
                                           uint64_t offset) {
  const uint4 ctr = make_uint4(static_cast<uint32_t>(i),
                               static_cast<uint32_t>(i >> 32),
                               static_cast<uint32_t>(offset),
                               static_cast<uint32_t>(offset >> 32));
  const uint4 bits = philox4x32_10(ctr, key);
  float u1 = static_cast<float>(bits.x >> 8) * (1.0f / 16777216.0f);
  const float u2 = static_cast<float>(bits.y >> 8) * (1.0f / 16777216.0f);
  u1 = fmaxf(u1, 1e-7f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

// Programmatic dependent launch (sm_90): wait for the previous grid in the
// stream to finish and flush; let the next grid in the stream start.  Both
// are no-ops in a grid launched without the attribute.
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;");
}

__global__ void __launch_bounds__(kThreads)
    reparam_kl_kernel(const float* __restrict__ mu,
                      const float* __restrict__ logvar,
                      float* __restrict__ out, int64_t n, uint64_t seed,
                      const int64_t* __restrict__ offset_at, int64_t start) {
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the previous grid may have written the offset: read it after the wait
  wait_for_previous_grid();
  const uint64_t offset = static_cast<uint64_t>(*offset_at);
  for (bool first = true; i < n; i += stride, first = false) {
    const float e = normal_at(start + i, key, offset);
    const float m = mu[i];
    const float lv = logvar[i];
    if (first) allow_next_grid();
    const float std = expf(__fmul_rn(0.5f, lv));
    const float elv = expf(lv);
    out[i] = __fadd_rn(m, __fmul_rn(e, std));
    out[n + i] = __fmul_rn(
        -0.5f, __fsub_rn(__fsub_rn(__fadd_rn(1.0f, lv), __fmul_rn(m, m)), elv));
    out[2 * n + i] = e;
  }
}

// The incoming gradients are read through the (row, column) strides of
// their [n / cols, cols] view: autograd hands the flagship's g_kl over as a
// broadcast (strides (1, 0), capacity mode's per-sample sum), which a copy
// to contiguous memory would cost a launch of its own.
struct Strided {
  const float* p;
  int64_t row, col;
};

__device__ __forceinline__ float load_at(Strided g, int64_t r, int64_t c) {
  return g.p[r * g.row + c * g.col];
}

__global__ void __launch_bounds__(kThreads)
    reparam_kl_backward_kernel(const float* __restrict__ mu,
                               const float* __restrict__ logvar,
                               const float* __restrict__ eps, Strided g_z,
                               Strided g_kl, float* __restrict__ out,
                               int64_t n, int64_t cols) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  wait_for_previous_grid();
  for (bool first = true; i < n; i += stride, first = false) {
    const int64_t r = i / cols;
    const int64_t c = i - r * cols;
    const float m = mu[i];
    const float lv = logvar[i];
    const float e = eps[i];
    const float gz = load_at(g_z, r, c);
    const float gk = load_at(g_kl, r, c);
    if (first) allow_next_grid();
    const float std = expf(__fmul_rn(0.5f, lv));
    const float elv = expf(lv);
    out[i] = __fadd_rn(gz, __fmul_rn(gk, m));
    out[n + i] = __fadd_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(0.5f, e), std), gz),
        __fmul_rn(__fmul_rn(0.5f, __fsub_rn(elv, 1.0f)), gk));
  }
}

// enough CTAs to cover n once, capped at 32 per SM of an H100's 132: the
// grid-stride loop covers the rest
int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int64_t n, void* stream, int pdl, Args... args) {
  if (n <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: [3, n] fp32, rows z, kl, eps; element i draws from the counter
// (start + i, *offset_at), the offset an int64 in device memory
extern "C" int betavae_reparam_kl(const float* mu, const float* logvar,
                                  float* out, int64_t n, uint64_t seed,
                                  const int64_t* offset_at, int64_t start,
                                  void* stream, int pdl) {
  if (start < 0 || offset_at == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(reparam_kl_kernel, n, stream, pdl, mu, logvar, out, n, seed,
                offset_at, start);
}

// out: [2, n] fp32, rows dmu, dlogvar; mu, logvar and eps contiguous, g_z
// and g_kl at (row, column) strides over [n / cols, cols]
extern "C" int betavae_reparam_kl_backward(
    const float* mu, const float* logvar, const float* eps, const float* g_z,
    int64_t g_z_row, int64_t g_z_col, const float* g_kl, int64_t g_kl_row,
    int64_t g_kl_col, float* out, int64_t n, int64_t cols, void* stream,
    int pdl) {
  if (n > 0 && cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(reparam_kl_backward_kernel, n, stream, pdl, mu, logvar, eps,
                Strided{g_z, g_z_row, g_z_col},
                Strided{g_kl, g_kl_row, g_kl_col}, out, n, cols);
}
