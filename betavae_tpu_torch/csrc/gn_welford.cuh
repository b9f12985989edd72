// PyTorch's GroupNorm statistics on the card, bit for bit: the Welford
// chains and merges that gn.cu (GroupNorm(1), a row a sample) and
// gn_silu.cu (GroupNorm(G), a row a (sample, group)) both run.
//
// PyTorch's GroupNorm on the card (RowwiseMomentsCUDAKernel, over the fp32
// values autocast gives it) runs a block of kChains threads a row, or a
// warp where the row has fewer values: thread t folds values t,
// t + kChains, ... into a Welford (mean, m2, n) in that order; the block
// then merges them by warp shuffles (lane l with lane l + 16, 8, 4, 2, 1),
// and the warps' results likewise in warp order, and takes var = m2/n,
// rstd = rsqrt(var + eps).  Every operation here is rounded as its compiled
// kernel rounds it.  A torch upgrade that changes those kernels must pass
// both files' bitwise card tests again (tests/test_torch_port_cuda.py
// -k "pytorchs_groupnorm or library_composition").
//
// Included by the .cu files of this directory; _build.py's digest of a
// library covers this header.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gn_welford {

constexpr int kChains = 512;          // PyTorch's kCUDABlockReduceNumThreads
constexpr int kSlots = kChains / 32;  // a row's warp results
constexpr int kAhead = 16;            // a chain's values loaded ahead

struct Welford {
  float mean, m2, n;
};

__device__ __forceinline__ int chains_for(int64_t n) {
  return n < kChains ? 32 : kChains;
}

__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ float value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ Welford add(Welford a, float x) {
  const float n = __fadd_rn(a.n, 1.0f);
  const float delta = __fsub_rn(x, a.mean);
  const float mean = __fadd_rn(a.mean, __fdiv_rn(delta, n));
  return {mean, __fmaf_rn(delta, __fsub_rn(x, mean), a.m2), n};
}

// a then b
__device__ __forceinline__ Welford merge(Welford a, Welford b) {
  if (a.n == 0.0f) return b;
  if (b.n == 0.0f) return a;
  const float delta = __fsub_rn(b.mean, a.mean);
  const float n = __fadd_rn(a.n, b.n);
  const float nb = __fdiv_rn(b.n, n);
  const float t = __fmul_rn(__fmul_rn(delta, delta), a.n);
  return {__fmaf_rn(delta, nb, a.mean),
          __fmaf_rn(t, nb, __fadd_rn(a.m2, b.m2)), n};
}

// lane l merged with lane l + 16, 8, 4, 2, 1 (PyTorch's WarpReduce); lane 0
// holds the warp's
__device__ __forceinline__ Welford warp_merge(Welford w) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Welford o = {__shfl_down_sync(0xffffffffu, w.mean, off),
                       __shfl_down_sync(0xffffffffu, w.m2, off),
                       __shfl_down_sync(0xffffffffu, w.n, off)};
    w = merge(w, o);
  }
  return w;
}

// Chain t of the n values of a row at `row` (values t, t + chains, ...),
// empty where t >= chains_for(n).  A chain is one dependent sequence of
// divisions: its next kAhead values load while these are folded in, and
// only the last, short run is folded under a bound check (a check a value
// doubled the chain's time on an H100).
template <typename T>
__device__ __forceinline__ Welford chain(const T* __restrict__ row,
                                         int64_t n, int t) {
  const int chains = chains_for(n);
  Welford w = {0.0f, 0.0f, 0.0f};
  if (t >= chains) return w;
  const T* __restrict__ xs = row + t;
  const int64_t len = (n - t + chains - 1) / chains;
  const int64_t full = len / kAhead * kAhead;
  float cur[kAhead], next[kAhead];
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cur[u] = value(xs[static_cast<int64_t>(u) * chains]);
    }
  }
  for (int64_t i0 = 0; i0 < full; i0 += kAhead) {
    const bool more = i0 + kAhead < full;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      next[u] = more ? value(xs[(i0 + kAhead + u) * chains]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) w = add(w, cur[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = next[u];
  }
  for (int64_t i = full; i < len; ++i) w = add(w, value(xs[i * chains]));
  return w;
}

// A row's kSlots warp results merged in slot order, as the block's last
// merge does; all 32 lanes of a warp call it and lane 0 holds the row's.
__device__ __forceinline__ Welford merge_slots(const Welford* slots) {
  const int lane = threadIdx.x % 32;
  Welford w = {0.0f, 0.0f, 0.0f};
  if (lane < kSlots) w = slots[lane];
  return warp_merge(w);
}

__device__ __forceinline__ float rstd_of(Welford w, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(w.m2, w.n), eps));
}

}  // namespace gn_welford
