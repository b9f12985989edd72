// Bilinear x2 upsampling with half-pixel centres and clamped edges
// (align_corners=False), forward and backward, NCHW, fp32 or bf16.
//
// What it replaces.  The JAX package writes this op as an XLA formulation,
// not a Pallas kernel: betavae_tpu/ops/upsample.py:32 bilinear_upsample_x2
// (edge-replicate pad, then per axis a depthwise conv with lhs_dilation 2
// and the taps [0.25, 0.75, 0.75, 0.25]), whose backward XLA derives as the
// transposed conv.  Per axis, with indices outside the image clamped to the
// border:
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
// versions in betavae_tpu_torch/ops/upsample.py compute them: the forward
// the H axis first, then W; the backward W first, then H; every product
// and sum in fp32 with explicitly rounded operations (__fmul_rn,
// __fadd_rn: nothing is fused into a multiply-add), rounded once to the
// output's dtype.  So kernel and plain version give the same bits, on both
// paths below.
//
// What bounds it on an H100 SXM (3.35 TB/s): each direction reads its
// input once and writes its output once, 1 value in for 4 out (forward) or
// 4 in for 1 out (backward), at 2 or 4 bytes a value, and does under 10
// fp32 operations a value: bound by bytes.  At the flagship's four
// upsamples a step (B = 32, bf16, 512@8^2 ... 64@64^2) that is 31.5 MB read
// and 126 MB written in the forward, about 0.047 ms.
//
// Two paths, chosen by a rule of shape, dtype and pointer alignment alone
// (ops/upsample.py::upsample_path; betavae_upsample_path below states the
// same rule in C), and the entry points launch exactly the path asked for
// or return an error: there is no fallback.
//
// The generic path (the first design, kept for every shape): forward, one
// thread per input pixel writes its 2x2 output block, two stores of two
// adjacent values (a bf16x2 or float2), from the clamped 3x3 neighbourhood
// it reads; backward, one thread per dx element reads its 4x4 window of dy
// (rows 2i-1 .. 2i+2, columns 2j-1 .. 2j+2), reduces each row over W, then
// the four rows over H.  What held it back on the H100 was instructions,
// not bytes: at every flagship shape bf16 took the time of fp32, which
// moves twice the bytes (64@64^2: forward 0.06991 vs 0.06990 ms, backward
// 0.08933 vs 0.08328; 0.35 / 0.28 of the bf16 byte bound at the flagship's
// four shapes).  The forward thread did three 64-bit divisions and modulos
// of its flat index and nine scalar 2-byte loads to end in two 4-byte
// stores (128 bytes a warp store); the backward thread did 16 scalar loads,
// each behind four bounds tests, for one 2-byte store, every dy value was
// loaded by four threads, and each W-reduction of a dy row was done again
// by the thread of the next dx row.
//
// The vector path (where a row is 1, 2, 4, ... or 32 units of 16 bytes and
// both pointers are 16-byte aligned: every shape of the flagship and the
// scaled config).  An item is (plane, band of rows, column group of V = 16
// / sizeof(T) columns: 8 in bf16, 4 in fp32); the grid is a flat 32-bit
// index over items, column group fastest, decoded with two multiply-high
// divisions by magic numbers (no division instruction, no 64-bit index
// arithmetic per thread).  A row's groups then sit in consecutive lanes of
// one warp, and a warp's items are whole bands of whole rows.
//   forward (bands of kFwdBand = 2 input rows): the thread loads the
//     kFwdBand + 2 input rows its band needs (each one 16-byte load, the
//     row above and below the band clamped), so each input row is loaded
//     once for the band rather than three times; per row it forms the
//     H-tap values of its V columns once and takes the one value left and
//     right of them from the neighbouring lanes (__shfl_up_sync /
//     __shfl_down_sync of the already H-tapped values: each serves every
//     output column that reads it).  Its 2V output columns of both output
//     rows (four 16-byte chunks) go to shared memory, where the warp's
//     output, one contiguous run of device memory, is staged; the warp
//     then writes the run in order, 512 contiguous bytes a store
//     instruction.  Stored straight from registers, the chunks of one
//     store instruction lay 32 to 256 bytes apart, and at planes of 8 x 8
//     that was no faster than the generic path (PERF.md).  The staging
//     slot of chunk c is c ^ ((c >> 3) & 7) ^ ((c >> 6) & 7), which
//     spreads the chunks that lanes 2 to 64 chunks apart stage at once
//     over the banks.  A plane of 8 x 8 in bf16 is one thread a band, 128
//     planes a CTA.
//   backward (bands of kBwdBand = 4 dx rows): the thread owns V
//     consecutive dx of each of its rows and writes each with one 16-byte
//     store.  It loads the 2 kBwdBand + 2 dy rows of its band (2i0-1 ...
//     2i0+2kBwdBand; rows outside dy read 0), each as two 16-byte loads of
//     its 2V columns plus one value each side from the neighbouring lanes,
//     reduces each dy row over W once, and each W-reduced row serves both
//     dx rows that read it.  So each dy byte is loaded once for the band,
//     with no reload by other threads.
//   Every lane of a warp runs the shuffles: threads past the last item
//   work on the last item and do not store.
//
// C interface, for ctypes: each entry returns the cudaError_t of the launch
// (0 on success).  The caller allocates every buffer and passes its current
// stream; nothing here allocates or synchronises.  dtype 0 is fp32, 1 bf16;
// path 0 is generic, 1 vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows a vector-path thread walks: forward input rows, backward dx rows
constexpr int kFwdBand = 2, kBwdBand = 4;
constexpr unsigned kFullMask = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// the generic path
// ---------------------------------------------------------------------------

// x [planes, H, W] -> y [planes, 2H, 2W].  Thread t is input pixel t of the
// flattened [planes, H, W]; the even output row 2i takes rows (i-1, i) with
// weights (0.25, 0.75), the odd one rows (i, i+1) with (0.75, 0.25), each
// reduced over H first, at columns j-1, j, j+1, then over W.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd_generic_kernel(const T* __restrict__ x, T* __restrict__ y,
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
upsample2x_bwd_generic_kernel(const T* __restrict__ dy, T* __restrict__ dx,
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

// ---------------------------------------------------------------------------
// the vector path
// ---------------------------------------------------------------------------

// n / d for 0 <= n < 2^31 as (umulhi(n, m) + n) >> s, with the magic
// number m and shift s of PyTorch's IntDivider (s = ceil(log2 d)); the sum
// stays under 2^32 because n does under 2^31.
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((uint64_t{1} << s) < d) ++s;
  const uint64_t m = ((uint64_t{1} << 32) * ((uint64_t{1} << s) - d)) / d + 1;
  return {d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

// 16 bytes of T as fp32 values: 4 floats or 8 bf16, unpacked from a
// 16-byte load or packed (rounded to T) for a 16-byte store
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[k];
      const float2 f = __bfloat1622float2(h);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__device__ __forceinline__ void store16(T* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Where an item sits: plane, first row of its band, first column of its
// group, and whether the groups left and right of it exist (they are the
// neighbouring lanes).
struct Item {
  uint32_t plane;
  int row0, col0;
  bool active, left, right;
};

template <int V, int kBand>
__device__ __forceinline__ Item locate(uint32_t items, const FastDiv& groups,
                                       const FastDiv& bands) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  Item it;
  it.active = t < items;
  const uint32_t n = it.active ? t : items - 1;
  const uint32_t rest = div_by(n, groups);
  const uint32_t g = n - rest * groups.d;
  it.plane = div_by(rest, bands);
  it.row0 = static_cast<int>(rest - it.plane * bands.d) * kBand;
  it.col0 = static_cast<int>(g) * V;
  it.left = g > 0;
  it.right = g + 1 < groups.d;
  return it;
}

// the staging slot of 16-byte chunk c of a warp's run
__device__ __forceinline__ uint32_t stage_slot(uint32_t c) {
  return c ^ ((c >> 3) & 7) ^ ((c >> 6) & 7);
}

// x [planes, H, W] -> y [planes, 2H, 2W], W / V a power of two up to 32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd_vector_kernel(const T* __restrict__ x, T* __restrict__ y,
                             uint32_t items, int H, int W, FastDiv groups,
                             FastDiv bands) {
  constexpr int V = Vec<T>::N;
  // each warp's output: 32 items x kFwdBand rows x four 16-byte chunks
  __shared__ uint4 stage[kThreads / 32][kFwdBand * 128];
  const Item it = locate<V, kFwdBand>(items, groups, bands);
  const T* xp = x + static_cast<size_t>(it.plane) * H * W;
  const size_t W2 = 2 * static_cast<size_t>(W);
  T* yp = y + static_cast<size_t>(it.plane) * 4 * H * W + 2 * it.col0;
  // the warp's output is one run of device memory from lane 0's first
  // chunk on (its items are whole bands of whole rows)
  T* const base = reinterpret_cast<T*>(__shfl_sync(
      kFullMask,
      reinterpret_cast<unsigned long long>(
          yp + static_cast<size_t>(2 * it.row0) * W2),
      0));
  uint4* run = stage[threadIdx.x >> 5];
  uint32_t end = 0;
  // input rows row0-1 .. row0+kFwdBand, clamped to the plane
  float xr[kFwdBand + 2][V];
#pragma unroll
  for (int r = 0; r < kFwdBand + 2; ++r) {
    const int i = min(max(it.row0 - 1 + r, 0), H - 1);
    Vec<T>::load(xp + static_cast<size_t>(i) * W + it.col0, xr[r]);
  }
#pragma unroll
  for (int r = 0; r < kFwdBand; ++r) {
    const int i = it.row0 + r;
    // the H taps of output rows 2i (e) and 2i+1 (o) at columns col0-1 ..
    // col0+V: index k+1 holds column col0+k
    float e[V + 2], o[V + 2];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      e[k + 1] = taps2(0.25f, xr[r][k], 0.75f, xr[r + 1][k]);
      o[k + 1] = taps2(0.75f, xr[r + 1][k], 0.25f, xr[r + 2][k]);
    }
    e[0] = __shfl_up_sync(kFullMask, e[V], 1);
    o[0] = __shfl_up_sync(kFullMask, o[V], 1);
    e[V + 1] = __shfl_down_sync(kFullMask, e[1], 1);
    o[V + 1] = __shfl_down_sync(kFullMask, o[1], 1);
    if (!it.left) {
      e[0] = e[1];
      o[0] = o[1];
    }
    if (!it.right) {
      e[V + 1] = e[V];
      o[V + 1] = o[V];
    }
    if (!it.active || i >= H) continue;
    // then the W taps: output columns 2(col0+k) and 2(col0+k)+1
    float ye[2 * V], yo[2 * V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ye[2 * k] = taps2(0.25f, e[k], 0.75f, e[k + 1]);
      ye[2 * k + 1] = taps2(0.75f, e[k + 1], 0.25f, e[k + 2]);
      yo[2 * k] = taps2(0.25f, o[k], 0.75f, o[k + 1]);
      yo[2 * k + 1] = taps2(0.75f, o[k + 1], 0.25f, o[k + 2]);
    }
    const uint32_t c = static_cast<uint32_t>(
        (yp + static_cast<size_t>(2 * i) * W2 - base) / V);
    const uint32_t c_odd = c + static_cast<uint32_t>(W2 / V);
    run[stage_slot(c)] = Vec<T>::pack(ye);
    run[stage_slot(c + 1)] = Vec<T>::pack(ye + V);
    run[stage_slot(c_odd)] = Vec<T>::pack(yo);
    run[stage_slot(c_odd + 1)] = Vec<T>::pack(yo + V);
    end = c_odd + 2;
  }
  // the warp writes its run in order: lane l the chunks l, l + 32, ...
  const uint32_t chunks = __reduce_max_sync(kFullMask, end);
  __syncwarp();
  for (uint32_t c = threadIdx.x & 31; c < chunks; c += 32) {
    store16(base + static_cast<size_t>(c) * V, run[stage_slot(c)]);
  }
}

// dy [planes, 2H, 2W] -> dx [planes, H, W], gather form, W / V a power of
// two up to 32.
// A dy row's W-reduction at the item's V dx columns, into s; a row outside
// dy (gr out of [0, 2H)) reads 0, as the plain version's zero padding does
// (its loads go to the nearest row and are dropped).
template <typename T>
__device__ __forceinline__ void reduce_dy_row(const T* gp, int gr, int H2,
                                              int W2, const Item& it,
                                              float* s) {
  constexpr int V = Vec<T>::N;
  const bool inside = gr >= 0 && gr < H2;
  const T* row = gp + static_cast<size_t>(min(max(gr, 0), H2 - 1)) * W2;
  // dy columns 2 col0 - 1 .. 2 col0 + 2V: index m+1 holds 2 col0 + m
  float g[2 * V + 2];
  Vec<T>::load(row + 2 * it.col0, g + 1);
  Vec<T>::load(row + 2 * it.col0 + V, g + 1 + V);
  if (!inside) {
#pragma unroll
    for (int m = 1; m <= 2 * V; ++m) g[m] = 0.0f;
  }
  g[0] = __shfl_up_sync(kFullMask, g[2 * V], 1);
  g[2 * V + 1] = __shfl_down_sync(kFullMask, g[1], 1);
  if (!it.left) g[0] = 0.0f;
  if (!it.right) g[2 * V + 1] = 0.0f;
  const int W = W2 / 2;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = it.col0 + k;
    const float wc1 = j == 0 ? 1.0f : 0.75f, wc2 = j == W - 1 ? 1.0f : 0.75f;
    s[k] = taps4(0.25f, g[2 * k], wc1, g[2 * k + 1], wc2, g[2 * k + 2], 0.25f,
                 g[2 * k + 3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd_vector_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                             uint32_t items, int H, int W, FastDiv groups,
                             FastDiv bands) {
  constexpr int V = Vec<T>::N;
  const Item it = locate<V, kBwdBand>(items, groups, bands);
  const int H2 = 2 * H, W2 = 2 * W;
  const T* gp = dy + static_cast<size_t>(it.plane) * 4 * H * W;
  T* xp = dx + static_cast<size_t>(it.plane) * H * W + it.col0;
  // the W-reduced dy rows 2i-1 .. 2i+2 of dx row i = row0 + r: rows 2r ..
  // 2r+3 of the band's 2 kBwdBand + 2, each reduced once
  float s[2 * kBwdBand + 2][V];
  reduce_dy_row(gp, 2 * it.row0 - 1, H2, W2, it, s[0]);
  reduce_dy_row(gp, 2 * it.row0, H2, W2, it, s[1]);
#pragma unroll
  for (int r = 0; r < kBwdBand; ++r) {
    const int i = it.row0 + r;
    reduce_dy_row(gp, 2 * i + 1, H2, W2, it, s[2 * r + 2]);
    reduce_dy_row(gp, 2 * i + 2, H2, W2, it, s[2 * r + 3]);
    if (!it.active || i >= H) continue;
    const float wr1 = i == 0 ? 1.0f : 0.75f, wr2 = i == H - 1 ? 1.0f : 0.75f;
    float out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = taps4(0.25f, s[2 * r][k], wr1, s[2 * r + 1][k], wr2,
                     s[2 * r + 2][k], 0.25f, s[2 * r + 3][k]);
    }
    store16(xp + static_cast<size_t>(i) * W, Vec<T>::pack(out));
  }
}

// The rule of ops/upsample.py::upsample_path: the vector path where the
// dtype is fp32 or bf16, W / V (V = 16 / sizeof(T)) is 1, 2, 4, 8, 16 or
// 32 (every row then starts on a 16-byte boundary and a warp holds whole
// rows), both pointers are 16-byte aligned (alignment: the largest power
// of two, up to 16, dividing both), and planes * H * (W / V), which bounds
// the item count, is under 2^31.
bool vector_ok(int64_t planes, int H, int W, int dtype, int64_t alignment) {
  if ((dtype != 0 && dtype != 1) || planes <= 0 || H <= 0 || W <= 0) {
    return false;
  }
  const int v = dtype == 1 ? 8 : 4;
  const int groups = W / v;
  return alignment % 16 == 0 && W % v == 0 && groups <= 32 &&
         (groups & (groups - 1)) == 0 &&
         planes * H * groups < (int64_t{1} << 31);
}

template <typename T, bool kBackward>
int launch_vector(const void* src, void* dst, int64_t planes, int H, int W,
                  cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const int band = kBackward ? kBwdBand : kFwdBand;
  const uint32_t groups = static_cast<uint32_t>(W / V);
  const uint32_t bands = static_cast<uint32_t>((H + band - 1) / band);
  const uint32_t items = static_cast<uint32_t>(planes) * bands * groups;
  const int blocks = blocks_for(items);
  if (kBackward) {
    upsample2x_bwd_vector_kernel<T><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), items, H, W,
        fast_div(groups), fast_div(bands));
  } else {
    upsample2x_fwd_vector_kernel<T><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), items, H, W,
        fast_div(groups), fast_div(bands));
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBackward>
int launch(const void* src, void* dst, int64_t planes, int H, int W,
           int dtype, int path, void* stream) {
  if ((dtype != 0 && dtype != 1) || (path != 0 && path != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = planes * H * W;
  if (total <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                           reinterpret_cast<uintptr_t>(dst);
    const int64_t alignment = (bits & 15) == 0 ? 16 : 0;
    if (!vector_ok(planes, H, W, dtype, alignment)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return dtype == 0
               ? launch_vector<float, kBackward>(src, dst, planes, H, W, st)
               : launch_vector<__nv_bfloat16, kBackward>(src, dst, planes, H,
                                                         W, st);
  }
  if ((total + kThreads - 1) / kThreads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (dtype == 0) {
    auto kernel = kBackward ? upsample2x_bwd_generic_kernel<float>
                            : upsample2x_fwd_generic_kernel<float>;
    kernel<<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), total, H,
        W);
  } else {
    auto kernel = kBackward ? upsample2x_bwd_generic_kernel<__nv_bfloat16>
                            : upsample2x_fwd_generic_kernel<__nv_bfloat16>;
    kernel<<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src),
        static_cast<__nv_bfloat16*>(dst), total, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 where the vector path takes x (or dx) [planes, H, W] of this dtype with
// both pointers aligned to `alignment` bytes, else 0 (the generic path).
extern "C" int betavae_upsample_path(int64_t planes, int H, int W, int dtype,
                                     int64_t alignment) {
  return vector_ok(planes, H, W, dtype, alignment) ? 1 : 0;
}

// x [planes, H, W] -> y [planes, 2H, 2W], both contiguous, in one dtype, on
// the path asked for (an error where the rule refuses the vector path).
extern "C" int betavae_upsample2x_fwd(const void* x, void* y, int64_t planes,
                                      int H, int W, int dtype, int path,
                                      void* stream) {
  return launch<false>(x, y, planes, H, W, dtype, path, stream);
}

// dy [planes, 2H, 2W] -> dx [planes, H, W], both contiguous, in one dtype;
// H and W are dx's.
extern "C" int betavae_upsample2x_bwd(const void* dy, void* dx, int64_t planes,
                                      int H, int W, int dtype, int path,
                                      void* stream) {
  return launch<true>(dy, dx, planes, H, W, dtype, path, stream);
}
