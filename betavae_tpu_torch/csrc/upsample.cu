// Bilinear x2 upsampling with half-pixel centres and clamped edges
// (align_corners=False), forward and backward, NCHW, fp32 or bf16.
//
// The JAX package writes this op as an XLA formulation, not a Pallas kernel:
// betavae_tpu/ops/upsample.py:32 bilinear_upsample_x2 (edge-replicate pad,
// then per axis a depthwise conv with lhs_dilation 2 and the taps
// [0.25, 0.75, 0.75, 0.25]), whose backward XLA derives as the transposed
// conv.  Per axis, with indices outside the image clamped to the border:
//
//     out[2i]   = 0.25 * x[i-1] + 0.75 * x[i]
//     out[2i+1] = 0.75 * x[i]   + 0.25 * x[i+1]
//
// The port replaces torch's F.interpolate because its backward scatters each
// dy into dx with atomics, in an order that changes from run to run, so two
// runs of one seed part after the first step.  The backward here is the
// gather form: each dx element is written by exactly one thread, which sums
// the dy taps that touch it in a fixed order, with no atomics, so two
// launches on the same input give the same bits.  Per axis, for an input of
// n values and a gradient g of 2n, with g read as 0 outside [0, 2n):
//
//     dx[i] = 0.25 * g[2i-1] + w1(i) * g[2i] + w2(i) * g[2i+1] + 0.25 * g[2i+2]
//     w1(i) = 0.75, or 1.0 at i = 0      (the clamped tap of out[0] folds in)
//     w2(i) = 0.75, or 1.0 at i = n-1    (the clamped tap of out[2n-1])
//
// Both directions are separable and are computed as the plain PyTorch
// versions in betavae_tpu_torch/ops/upsample.py compute them: the H axis
// first, then the W axis, every product and sum in fp32 with explicitly
// rounded operations (__fmul_rn, __fadd_rn: nothing is fused into a
// multiply-add), rounded once to the output's dtype.  So kernel and plain
// version give the same bits.
//
// Bound on an H100 SXM (3.35 TB/s): each direction reads its input once and
// writes its output once, 1 value in for 4 out (forward) or 4 in for 1 out
// (backward), at 2 or 4 bytes a value, and does under 10 fp32 operations a
// value: bound by bytes.  At the flagship's four upsamples a step (B = 32,
// bf16, 512@8^2 ... 64@64^2) that is 31.5 MB read and 126 MB written in the
// forward, about 0.047 ms.
//
// Design, first version (a simple kernel that is right; speed is later
// work).  Forward: one thread per input pixel (i, j) of a plane writes its
// 2x2 output block, two stores of two adjacent values (a bf16x2 or float2),
// from the clamped 3x3 neighbourhood it reads; neighbouring threads read
// neighbouring pixels and write neighbouring pairs.  Backward: one thread
// per dx element reads its 4x4 window of dy (rows 2i-1 .. 2i+2, columns
// 2j-1 .. 2j+2), reduces each row over W, then the four rows over H.
//
// C interface, for ctypes: each entry returns the cudaError_t of the launch
// (0 on success).  The caller allocates every buffer and passes its current
// stream; nothing here allocates or synchronises.  dtype 0 is fp32, 1 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_pair(float* p, int64_t i, float a,
                                           float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int64_t i,
                                           float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p + i) = v;
}

__device__ __forceinline__ void store_one(float* p, int64_t i, float a) {
  p[i] = a;
}
__device__ __forceinline__ void store_one(__nv_bfloat16* p, int64_t i,
                                          float a) {
  p[i] = __float2bfloat16_rn(a);
}

// wa * a + wb * b, each product and the sum rounded on their own
__device__ __forceinline__ float taps2(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// ((w0 a + w1 b) + w2 c) + w3 d, in that order
__device__ __forceinline__ float taps4(float w0, float a, float w1, float b,
                                       float w2, float c, float w3, float d) {
  float acc = __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
  acc = __fadd_rn(acc, __fmul_rn(w2, c));
  return __fadd_rn(acc, __fmul_rn(w3, d));
}

// x [planes, H, W] -> y [planes, 2H, 2W].  Thread t is input pixel t of the
// flattened [planes, H, W]; the even output row 2i takes rows (i-1, i) with
// weights (0.25, 0.75), the odd one rows (i, i+1) with (0.75, 0.25), each
// reduced over H first, at columns j-1, j, j+1, then over W.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                      int64_t total, int H, int W) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % W);
  const int64_t pi = t / W;
  const int i = static_cast<int>(pi % H);
  const int64_t plane = pi / H;
  const T* xp = x + plane * H * W;
  const int im = i > 0 ? i - 1 : 0, ip = i < H - 1 ? i + 1 : H - 1;
  const int jm = j > 0 ? j - 1 : 0, jp = j < W - 1 ? j + 1 : W - 1;
  const int cols[3] = {jm, j, jp};
  float even[3], odd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = load_f(xp, static_cast<int64_t>(im) * W + cols[c]);
    const float b = load_f(xp, static_cast<int64_t>(i) * W + cols[c]);
    const float d = load_f(xp, static_cast<int64_t>(ip) * W + cols[c]);
    even[c] = taps2(0.25f, a, 0.75f, b);
    odd[c] = taps2(0.75f, b, 0.25f, d);
  }
  const int64_t W2 = 2 * static_cast<int64_t>(W);
  T* yp = y + plane * 4 * H * W + static_cast<int64_t>(2 * i) * W2 + 2 * j;
  store_pair(yp, 0, taps2(0.25f, even[0], 0.75f, even[1]),
             taps2(0.75f, even[1], 0.25f, even[2]));
  store_pair(yp, W2, taps2(0.25f, odd[0], 0.75f, odd[1]),
             taps2(0.75f, odd[1], 0.25f, odd[2]));
}

// dy [planes, 2H, 2W] -> dx [planes, H, W], gather form.  Thread t is dx
// element t of the flattened [planes, H, W].  Rows 2i-1 .. 2i+2 of dy are
// each reduced over columns 2j-1 .. 2j+2, then the four row sums over H,
// with the weights of the header; a tap outside dy reads 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                      int64_t total, int H, int W) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % W);
  const int64_t pi = t / W;
  const int i = static_cast<int>(pi % H);
  const int64_t plane = pi / H;
  const int H2 = 2 * H, W2 = 2 * W;
  const T* g = dy + plane * 4 * H * W;
  const float wc1 = j == 0 ? 1.0f : 0.75f, wc2 = j == W - 1 ? 1.0f : 0.75f;
  const float wr1 = i == 0 ? 1.0f : 0.75f, wr2 = i == H - 1 ? 1.0f : 0.75f;
  float rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = 2 * i - 1 + r;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = 2 * j - 1 + c;
      v[c] = (gr >= 0 && gr < H2 && gc >= 0 && gc < W2)
                 ? load_f(g, static_cast<int64_t>(gr) * W2 + gc)
                 : 0.0f;
    }
    rows[r] = taps4(0.25f, v[0], wc1, v[1], wc2, v[2], 0.25f, v[3]);
  }
  store_one(dx, t, taps4(0.25f, rows[0], wr1, rows[1], wr2, rows[2], 0.25f,
                         rows[3]));
}

int blocks_for(int64_t total) {
  return static_cast<int>((total + kThreads - 1) / kThreads);
}

}  // namespace

// x [planes, H, W] -> y [planes, 2H, 2W], both contiguous, in one dtype.
extern "C" int betavae_upsample2x_fwd(const void* x, void* y, int64_t planes,
                                      int H, int W, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = planes * H * W;
  if (total <= 0) return 0;
  if ((total + kThreads - 1) / kThreads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    upsample2x_fwd_kernel<float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total, H, W);
  } else {
    upsample2x_fwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        total, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy [planes, 2H, 2W] -> dx [planes, H, W], both contiguous, in one dtype;
// H and W are dx's.
extern "C" int betavae_upsample2x_bwd(const void* dy, void* dx, int64_t planes,
                                      int H, int W, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = planes * H * W;
  if (total <= 0) return 0;
  if ((total + kThreads - 1) / kThreads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    upsample2x_bwd_kernel<float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<float*>(dx), total, H, W);
  } else {
    upsample2x_bwd_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
        total, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
