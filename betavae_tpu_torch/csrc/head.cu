// SE gate folded into the decoder's final 3x3 C->1 convolution: the forward
// kernel and the M reduction of its backward.
//
// Replaces the Pallas TPU kernels of betavae_tpu/ops/pallas_head.py:
//
//   _fwd_kernel (launched by _run_fwd, pallas_call at pallas_head.py:132)
//       out[b,h,w] = sum_{dh,dw,c} y[b,c,h+dh-1,w+dw-1] * s[b,c] * k[c,dh,dw]
//   _mkernel    (launched by _run_m,   pallas_call at pallas_head.py:156)
//       M[b,3*dh+dw,c] = sum_{h,w} y[b,c,h+dh-1,w+dw-1] * dy[b,h,w]
//
// with zero SAME padding (y is 0 outside the image), y NCHW in bf16 or fp32,
// s [B, C] in bf16 or fp32, k [C, 3, 3] and dy [B, H, W] in fp32, and every
// product and sum in fp32.  Bias, sigmoid and the rest of the backward
// (dk = sum_b s*M, ds = sum_tap k*M, dy_y) are the caller's torch ops, as
// in the JAX package.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
// cores), at the flagship's y [32, 64, 128, 128] bf16:
//   forward: 67.1 MB of y read once plus 2.1 MB of fp32 out written, 0.0207
//            ms; 604 MFLOP (9 taps x 64 channels x 2 per output pixel),
//            0.009 ms.  Bound by bytes.
//   M:       the same 67.1 MB of y plus 2.1 MB of dy read and 74 KB of M
//            written, 0.0207 ms; the same 604 MFLOP.  Bound by bytes.
// Both do under 9 operations per byte of y, far below the ~20 fp32
// operations per byte at which the card's arithmetic would limit, so the
// design aims to read y once, in wide coalesced rows, and to keep the 9 tap
// reuses of every y value on chip.
//
// Design (the TPU kernels' one-sample-per-grid-step VMEM blocks do not carry
// over: a Hopper block has 227 KB of shared memory, not ~100 MB):
//   A tile is 8 output rows x 128 output columns.  The (8+2) x (128+2) halo
//   of a few channels is staged in shared memory as fp32, zero outside the
//   image.  Each thread first issues all of its share of the staging loads
//   into registers (about 20, neighbouring threads on neighbouring
//   columns) and only then writes them to shared memory, so many loads are
//   in flight at once; and the loads of the next pass are issued before the
//   current pass is computed, so their latency hides behind that work.
//   Thread t owns column t%128 and the 4 rows 4*(t/128) .. +3 of the tile:
//   each halo value it reads from shared memory feeds up to 3 of its rows,
//   and a warp's reads fall on 32 distinct banks.
//   forward: one block per (tile, sample), grid (ceil(W/128), ceil(H/8), B).
//     Channels are staged 4 at a time together with sk[c,tap] = s[b,c] *
//     k[c,tap] folded for them; each output pixel's sum stays in a register
//     across all channels and is written once.
//   M: one block per (group of 4 channels, sample), grid (ceil(C/4), B).
//     The block walks the tiles of the plane; each thread reads its 4 dy
//     values straight into registers and keeps 4 x 9 partial sums, and a
//     warp-shuffle then cross-warp reduction in a fixed order writes M.
//     No atomics: the result is the same bits run to run.
//   Any B, C, H and W are taken: ragged tiles are zero-filled on load and
//   masked on store.  Offsets into y are 64-bit.
//
// C interface, for ctypes: each entry point returns the cudaError_t of its
// launch (0 on success), or cudaErrorInvalidValue for a dtype code or grid
// it does not take.  The caller allocates every buffer and passes its
// current stream; nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;                  // output rows per tile
constexpr int kTileW = 128;                // output columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPer = kTileH * kTileW / kThreads;   // rows per thread: 4
constexpr int kHaloH = kTileH + 2;
constexpr int kPad = 4;                    // shared columns left of the tile
constexpr int kHaloW = kTileW + 2 * kPad;  // 16-byte aligned rows
constexpr int kGroup = 4;                  // channels per stage (both kernels)
static_assert(kThreads == 2 * kTileW && kHaloH % 2 == 0,
              "the scalar staging gives each thread one column and every "
              "other row");
static_assert(kGroup * kHaloH * 2 <= kThreads, "one edge value per thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The eight bf16 values of one 16-byte load, as fp32 (a bf16 is the top
// half of its fp32), into the 16-byte aligned dst[0..8).
__device__ __forceinline__ void unpack_bf16x8(uint4 raw, float* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The halo of kGroup consecutive channel planes for the tile at (r0, c0):
// rows r0-1 .. r0+kTileH, columns c0-1 .. c0+kTileW, stored as fp32 at
// tile[ch][row][kPad - 1 + column], zero outside the image and for channels
// at or past `nvalid`.  load() issues this thread's share of the global
// reads into registers, store() writes them to the tile.  The 128 inner
// columns are read with 16-byte loads when kVec (the caller's guarantee:
// W a multiple of 16 bytes' worth of T and y 16-byte aligned), else one
// value per load, thread t taking column t%128 of every other row from row
// t/128; the first 80 threads read one value each of the two edge columns.
template <typename T, bool kVec>
struct Halo {
  static constexpr int kPerLoad = 16 / sizeof(T);
  static constexpr int kChunksPerRow = kTileW / kPerLoad;
  static constexpr int kChunks = kGroup * kHaloH * kChunksPerRow;
  static constexpr int kVecIters = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kSteps = kHaloH / 2;            // scalar rows per thread
  static constexpr int kEdges = kGroup * kHaloH * 2;   // edge values: 80
  uint4 vec[kVec ? kVecIters : 1];
  float v[kVec ? 1 : kGroup][kSteps];
  float edge;

  __device__ __forceinline__ void load(const T* __restrict__ y,
                                       int64_t plane0, int nvalid, int H,
                                       int W, int r0, int c0) {
    const int64_t plane = static_cast<int64_t>(H) * W;
    if constexpr (kVec) {
#pragma unroll
      for (int it = 0; it < kVecIters; ++it) {
        const int q = threadIdx.x + it * kThreads;
        const int ch = q / (kHaloH * kChunksPerRow);
        const int rem = q - ch * (kHaloH * kChunksPerRow);
        const int gr = r0 - 1 + rem / kChunksPerRow;
        const int gc = c0 + (rem % kChunksPerRow) * kPerLoad;
        vec[it] = (q < kChunks && ch < nvalid && gr >= 0 && gr < H && gc < W)
                      ? *reinterpret_cast<const uint4*>(
                            y + plane0 + ch * plane +
                            static_cast<int64_t>(gr) * W + gc)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      const int col = threadIdx.x % kTileW;
      const int gc = c0 + col;
      const T* base = y + plane0 + gc;
#pragma unroll
      for (int ch = 0; ch < kGroup; ++ch) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int gr = r0 - 1 + threadIdx.x / kTileW + 2 * j;
          v[ch][j] = (ch < nvalid && gc < W && gr >= 0 && gr < H)
                         ? to_float(base[ch * plane +
                                         static_cast<int64_t>(gr) * W])
                         : 0.0f;
        }
      }
    }
    edge = 0.0f;
    if (threadIdx.x < kEdges) {
      const int ch = threadIdx.x / (kHaloH * 2);
      const int rem = threadIdx.x - ch * (kHaloH * 2);
      const int gr = r0 - 1 + rem / 2;
      const int gce = (rem % 2) ? c0 + kTileW : c0 - 1;
      if (ch < nvalid && gr >= 0 && gr < H && gce >= 0 && gce < W) {
        edge = to_float(y[plane0 + ch * plane + static_cast<int64_t>(gr) * W +
                          gce]);
      }
    }
  }

  __device__ __forceinline__ void store(float (*tile)[kHaloH][kHaloW]) const {
    if constexpr (kVec) {
#pragma unroll
      for (int it = 0; it < kVecIters; ++it) {
        const int q = threadIdx.x + it * kThreads;
        if (q < kChunks) {
          const int ch = q / (kHaloH * kChunksPerRow);
          const int rem = q - ch * (kHaloH * kChunksPerRow);
          float* dst = &tile[ch][rem / kChunksPerRow]
                            [kPad + (rem % kChunksPerRow) * kPerLoad];
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(dst) =
                *reinterpret_cast<const float4*>(&vec[it]);
          } else {
            unpack_bf16x8(vec[it], dst);
          }
        }
      }
    } else {
      const int col = threadIdx.x % kTileW;
#pragma unroll
      for (int ch = 0; ch < kGroup; ++ch) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          tile[ch][threadIdx.x / kTileW + 2 * j][kPad + col] = v[ch][j];
        }
      }
    }
    if (threadIdx.x < kEdges) {
      const int ch = threadIdx.x / (kHaloH * 2);
      const int rem = threadIdx.x - ch * (kHaloH * 2);
      tile[ch][rem / 2][(rem % 2) ? kPad + kTileW : kPad - 1] = edge;
    }
  }
};

template <typename TY, typename TS, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    head_fwd_kernel(const TY* __restrict__ y, const TS* __restrict__ s,
                    const float* __restrict__ k, float* __restrict__ out,
                    int C, int H, int W) {
  __shared__ __align__(16) float tile[kGroup][kHaloH][kHaloW];
  __shared__ float sk[kGroup][9];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int col = threadIdx.x % kTileW;
  const int row0 = (threadIdx.x / kTileW) * kRowsPer;
  const int64_t sample0 = static_cast<int64_t>(b) * C;

  float acc[kRowsPer];
#pragma unroll
  for (int p = 0; p < kRowsPer; ++p) acc[p] = 0.0f;

  Halo<TY, kVec> halo;
  halo.load(y, sample0 * H * W, min(kGroup, C), H, W, r0, c0);
  for (int cb = 0; cb < C; cb += kGroup) {
    const int nvalid = min(kGroup, C - cb);
    __syncthreads();  // the previous pass has finished reading the tiles
    halo.store(tile);
    if (threadIdx.x < kGroup * 9) {
      const int ch = threadIdx.x / 9;
      const int tap = threadIdx.x - ch * 9;
      sk[ch][tap] = ch < nvalid
                        ? to_float(s[sample0 + cb + ch]) * k[(cb + ch) * 9 + tap]
                        : 0.0f;
    }
    __syncthreads();
    const int next = cb + kGroup;
    if (next < C) {  // in flight while this pass computes
      halo.load(y, (sample0 + next) * H * W, min(kGroup, C - next), H, W, r0,
                c0);
    }
#pragma unroll
    for (int ch = 0; ch < kGroup; ++ch) {
      float w[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) w[tap] = sk[ch][tap];
#pragma unroll
      for (int rr = 0; rr < kRowsPer + 2; ++rr) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float v = tile[ch][row0 + rr][kPad - 1 + col + dw];
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const int p = rr - dh;  // output row row0+p reads halo row p+dh
            if (p >= 0 && p < kRowsPer) acc[p] = fmaf(v, w[dh * 3 + dw], acc[p]);
          }
        }
      }
    }
  }

  const int gc = c0 + col;
  if (gc < W) {
#pragma unroll
    for (int p = 0; p < kRowsPer; ++p) {
      const int gr = r0 + row0 + p;
      if (gr < H) out[(static_cast<int64_t>(b) * H + gr) * W + gc] = acc[p];
    }
  }
}

template <typename TY, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    head_m_kernel(const TY* __restrict__ y, const float* __restrict__ dy,
                  float* __restrict__ m, int C, int H, int W) {
  __shared__ __align__(16) float tile[kGroup][kHaloH][kHaloW];
  __shared__ float partial[kWarps][kGroup * 9];
  const int b = blockIdx.y;
  const int cb = blockIdx.x * kGroup;
  const int nvalid = min(kGroup, C - cb);
  const int col = threadIdx.x % kTileW;
  const int row0 = (threadIdx.x / kTileW) * kRowsPer;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t plane0 = (static_cast<int64_t>(b) * C + cb) * H * W;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles = ((H + kTileH - 1) / kTileH) * tiles_w;

  float acc[kGroup][9];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) acc[g][tap] = 0.0f;
  }

  // this thread's dy of a tile: one pixel per owned row, zero outside
  auto load_dy = [&](int t, float (&d)[kRowsPer]) {
    const int r0 = (t / tiles_w) * kTileH;
    const int gc = (t % tiles_w) * kTileW + col;
#pragma unroll
    for (int p = 0; p < kRowsPer; ++p) {
      const int gr = r0 + row0 + p;
      d[p] = (gr < H && gc < W)
                 ? dy[(static_cast<int64_t>(b) * H + gr) * W + gc]
                 : 0.0f;
    }
  };

  Halo<TY, kVec> halo;
  float d_next[kRowsPer];
  halo.load(y, plane0, nvalid, H, W, 0, 0);
  load_dy(0, d_next);
  for (int t = 0; t < tiles; ++t) {
    float d[kRowsPer];
#pragma unroll
    for (int p = 0; p < kRowsPer; ++p) d[p] = d_next[p];
    __syncthreads();  // the previous tile has been read
    halo.store(tile);
    __syncthreads();
    if (t + 1 < tiles) {  // in flight while this tile computes
      halo.load(y, plane0, nvalid, H, W, ((t + 1) / tiles_w) * kTileH,
                ((t + 1) % tiles_w) * kTileW);
      load_dy(t + 1, d_next);
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int rr = 0; rr < kRowsPer + 2; ++rr) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float v = tile[g][row0 + rr][kPad - 1 + col + dw];
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const int p = rr - dh;  // dy row row0+p meets halo row p+dh
            if (p >= 0 && p < kRowsPer) {
              acc[g][dh * 3 + dw] = fmaf(v, d[p], acc[g][dh * 3 + dw]);
            }
          }
        }
      }
    }
  }

  // fixed-order reduction: lanes by shuffle, then warps in index order
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      float v = acc[g][tap];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) partial[warp][g * 9 + tap] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kGroup * 9) {
    const int g = threadIdx.x / 9;
    const int tap = threadIdx.x - g * 9;
    float total = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) total += partial[wi][threadIdx.x];
    if (g < nvalid) m[(static_cast<int64_t>(b) * 9 + tap) * C + cb + g] = total;
  }
}

// 16-byte loads of y's inner columns need every row to start on a 16-byte
// boundary: y aligned and W a multiple of the values per load.
template <typename T>
bool rows_aligned(const void* y, int W) {
  return reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         W % static_cast<int>(16 / sizeof(T)) == 0;
}

template <typename TY, typename TS>
void launch_fwd(const void* y, const void* s, const float* k, float* out,
                int C, int H, int W, dim3 grid, cudaStream_t stream) {
  const TY* yt = static_cast<const TY*>(y);
  const TS* st = static_cast<const TS*>(s);
  if (rows_aligned<TY>(y, W)) {
    head_fwd_kernel<TY, TS, true><<<grid, kThreads, 0, stream>>>(
        yt, st, k, out, C, H, W);
  } else {
    head_fwd_kernel<TY, TS, false><<<grid, kThreads, 0, stream>>>(
        yt, st, k, out, C, H, W);
  }
}

template <typename TY>
void launch_m(const void* y, const float* dy, float* m, int C, int H, int W,
              dim3 grid, cudaStream_t stream) {
  const TY* yt = static_cast<const TY*>(y);
  if (rows_aligned<TY>(y, W)) {
    head_m_kernel<TY, true><<<grid, kThreads, 0, stream>>>(yt, dy, m, C, H, W);
  } else {
    head_m_kernel<TY, false><<<grid, kThreads, 0, stream>>>(yt, dy, m, C, H, W);
  }
}

constexpr int kMaxGridYZ = 65535;

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int betavae_head_fwd(const void* y, const void* s, const float* k,
                                float* out, int B, int C, int H, int W,
                                int y_dtype, int s_dtype, void* stream,
                                int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((y_dtype != 0 && y_dtype != 1) || (s_dtype != 0 && s_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0) {
    // no channels: the sum is empty
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * H * W * sizeof(float), st));
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  if (grid.y > kMaxGridYZ || grid.z > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (y_dtype == 1 && s_dtype == 1) {
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(y, s, k, out, C, H, W, grid, st);
  } else if (y_dtype == 1) {
    launch_fwd<__nv_bfloat16, float>(y, s, k, out, C, H, W, grid, st);
  } else if (s_dtype == 1) {
    launch_fwd<float, __nv_bfloat16>(y, s, k, out, C, H, W, grid, st);
  } else {
    launch_fwd<float, float>(y, s, k, out, C, H, W, grid, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int betavae_head_m(const void* y, const float* dy, float* m,
                              int B, int C, int H, int W, int y_dtype,
                              void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (y_dtype != 0 && y_dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) {
    // an empty plane: every sum is empty
    return static_cast<int>(cudaMemsetAsync(
        m, 0, static_cast<size_t>(B) * 9 * C * sizeof(float), st));
  }
  const dim3 grid((C + kGroup - 1) / kGroup, B);
  if (grid.y > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  if (y_dtype == 1) {
    launch_m<__nv_bfloat16>(y, dy, m, C, H, W, grid, st);
  } else {
    launch_m<float>(y, dy, m, C, H, W, grid, st);
  }
  return static_cast<int>(cudaGetLastError());
}
