// Fused reparameterisation sample + elementwise KL for the β-VAE latent.
//
// Replaces the Pallas TPU kernel betavae_tpu/ops/pallas_elbo.py::_kernel
// (launched by _run_kernel, pallas_call at pallas_elbo.py:79).  One pass over
// fp32 mu and logvar of n elements writes
//
//     eps ~ N(0, 1)                         (generated here, never read)
//     z   = mu + eps * exp(logvar / 2)
//     kl  = -(1 + logvar - mu^2 - exp(logvar)) / 2
//
// Noise: Philox4x32-10 keyed by the 64-bit seed, with the 128-bit counter
// (element index, offset), so each element's draw is independent of the
// launch shape and a (seed, offset) pair replays bitwise.  Box-Muller on the
// top 24 bits of two words, u1 clamped at 1e-7, the cosine branch only: the
// transform of pallas_elbo.py:49-60.  The TPU kernel uses the TPU's own
// PRNG, so the streams differ by design; the distribution is the same.
//
// Bound on an H100: 5 arrays x 4 B per element (2 read, 3 written), 40 KB at
// the flagship's [32, 64], i.e. ~12 ns of HBM time at 3.35 TB/s; the
// arithmetic (10 Philox rounds, log, sqrt, cos, two exp) is a few hundred
// integer and fp32 operations per element.  At that size the launch itself
// (microseconds) is the whole cost, so the design is the simplest one: one
// thread per element in a grid-stride loop, no shared memory.  z and kl use
// explicitly rounded operations (__fmul_rn etc.) so that no multiply-add is
// fused: they round exactly like the plain PyTorch version given the same
// eps, which lets the check against it be tight.
//
// C interface, for ctypes: betavae_reparam_kl returns the cudaError_t of the
// launch (0 on success).  The caller allocates every buffer and passes its
// current stream; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

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

__global__ void reparam_kl_kernel(const float* __restrict__ mu,
                                  const float* __restrict__ logvar,
                                  float* __restrict__ z,
                                  float* __restrict__ kl,
                                  float* __restrict__ eps, int64_t n,
                                  uint64_t seed, uint64_t offset) {
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint4 ctr = make_uint4(static_cast<uint32_t>(i),
                                 static_cast<uint32_t>(i >> 32),
                                 static_cast<uint32_t>(offset),
                                 static_cast<uint32_t>(offset >> 32));
    const uint4 bits = philox4x32_10(ctr, key);
    float u1 = static_cast<float>(bits.x >> 8) * (1.0f / 16777216.0f);
    const float u2 = static_cast<float>(bits.y >> 8) * (1.0f / 16777216.0f);
    u1 = fmaxf(u1, 1e-7f);
    const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    const float e = __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));

    const float m = mu[i];
    const float lv = logvar[i];
    const float std = expf(__fmul_rn(0.5f, lv));
    const float elv = expf(lv);
    z[i] = __fadd_rn(m, __fmul_rn(e, std));
    kl[i] = __fmul_rn(
        -0.5f, __fsub_rn(__fsub_rn(__fadd_rn(1.0f, lv), __fmul_rn(m, m)), elv));
    eps[i] = e;
  }
}

}  // namespace

extern "C" int betavae_reparam_kl(const float* mu, const float* logvar,
                                  float* z, float* kl, float* eps, int64_t n,
                                  uint64_t seed, uint64_t offset,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  // enough blocks to cover n once, capped at 32 per SM of an H100's 132:
  // the grid-stride loop covers the rest
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  reparam_kl_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      mu, logvar, z, kl, eps, n, seed, offset);
  return static_cast<int>(cudaGetLastError());
}
