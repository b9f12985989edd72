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
// cores), at the flagship's y [32, 64, 128, 128] bf16: 67.1 MB of y read
// once plus 2.1 MB of fp32 out written (forward) or of dy read (M, which
// also writes 74 KB), 0.0207 ms; 604 MFLOP (9 taps x 64 channels x 2 per
// output pixel), 0.009 ms.  Both are bound by bytes, at under 9 operations
// per byte of y, so a kernel reaches its bound only if y streams in without
// stalling the arithmetic, and the 9 tap reuses of each value stay on chip.
//
// Two paths.  The TMA path below takes every y whose rows TMA can describe
// (y, and dy for M, 16-byte aligned; a row of W values a multiple of 16
// bytes): the flagship's shapes.  The generic path (the kernels of the first
// design, further down) takes the rest: misaligned y, and rows such as 53
// fp32 or 130 bf16 values.  tma_rows() decides; betavae_head_tma_path()
// exports the same rule, and the wrapper counts launches by path.
//
// What limited the first design (one CTA per 8x128 tile, 4 channels a pass),
// and what the TMA path does about each:
//   - 512 forward CTAs at 3 per SM: 1.29 waves, the last third of a wave
//     with under a third of the card's loads in flight.  Now a persistent
//     grid: as many CTAs as the SMs hold (SM count and occupancy read once
//     and cached), each walking work items in a fixed order.  Forward: an
//     item is (sample, band of 32 rows, 128-column tile); at the flagship 32
//     x 4 = 128 items on 132 resident CTAs (one an SM: a CTA's ring takes
//     157 KB): one wave, 4 SMs idle.  M: an item is (sample, 8 bf16 or 4
//     fp32 channels), 256 bf16 items on 132 CTAs: 1.94 sweeps, 97 % of the
//     slots used; a CTA walks the 4 bands of its plane, two stage boxes of
//     channels a band, and reduces once, so there are no per-band partials,
//     no second launch and no atomics (the same bits every run).  The two
//     boxes share one dy tile, which halves dy's passes through shared
//     memory against one box an item (measured faster in bf16).
//   - Synchronous staging: each pass's loads went through registers, with
//     two __syncthreads a pass and one pass of loads in flight.  Now TMA
//     (cp.async.bulk.tensor) loads each halo box into a ring (4 stages
//     forward, 3 for M, whose stages have room for dy) with full and empty
//     mbarriers; a producer warp keeps the ring full ahead of 8 consumer
//     warps; the main loop has no __syncthreads.  The tensor map describes
//     y as [B, C, H, W] in its own dtype; a box starts at row r0-1 and 16
//     bytes left of the tile (TMA faulted with an illegal instruction on a
//     box whose first column is not 16-byte aligned, such as c0-1), and
//     TMA's zero fill of what lies outside the tensor is the SAME padding
//     (and zero channels past C), so no thread does address or bounds
//     arithmetic for y.  M's dy tile comes in the same stage, by a second
//     map.  The forward's producer issues a stage's box before it folds the
//     stage's s[b,c]*k[c,tap] beside it, so those loads do not delay the box.
//   - fp32 tiles: bf16 staged as fp32 doubled the shared bytes.  Now y stays
//     in its dtype in shared memory, 4 bf16 channels (2 fp32) of a 34 x 144
//     (136) box a stage, 39 KB (37 KB); each read converts a pair.
//   - 18 shared loads for 36 FMAs a channel.  Now a thread owns 2 adjacent
//     columns of 8 rows: per channel it reads 10 rows x 3 aligned pairs
//     (neighbouring threads on neighbouring words) for 144 FMAs, 0.21 loads
//     an FMA.
//   - 1.25x of y through L2 (10 rows for 8).  Now 34 rows for 32: 1.06x.
// Bands of 32 rows (8 a thread, one CTA an SM), not 16 (4 a thread, two
// CTAs an SM): on the H100 both kernels ran faster so in both dtypes.  What
// is left is the consumers' issue: per channel and thread 30 shared loads,
// 40 bf16 conversions and 144 FMAs, about 16 us of issue an SM at the
// flagship beside the 20.7 us byte bound.  Inside a training step both
// kernels also pay for the write-back of the dirty lines earlier ops left
// in L2 (up to 50 MB): chip_smoke.py times them after a clean and a dirty
// flush of L2.
//
// fp32 FMA, not tensor cores: the work is under 9 operations per byte, so
// the FMA pipes (0.009 ms at the flagship) are not the limit, and mma or
// wgmma would keep the fp32 contract on the fp32 operands (dy for M, s*k
// for the forward) only with a three-way bf16 split of them, tripling the
// products for no gain at a byte bound.
//
// C interface, for ctypes: each entry point returns the cudaError_t of its
// launch (0 on success), or cudaErrorInvalidValue for a dtype code or grid
// it does not take.  The caller allocates every buffer and passes its
// current stream; nothing here allocates or synchronises.

#include <cuda.h>           // CUtensorMap and its enums (header only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// ---------------------------------------------------------------------------
// The generic path: the first design, for rows TMA cannot describe.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The TMA path
// ---------------------------------------------------------------------------

namespace tma {

constexpr int kConsumers = 256;                 // 8 consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;       // + 1 producer warp
constexpr int kTileW = 128;                     // output columns per tile
constexpr int kPairs = kTileW / 2;              // a thread owns 2 columns
constexpr int kRowGroups = kConsumers / kPairs;  // 4
constexpr int kRowsPer = 8;                     // and 8 rows
constexpr int kBand = kRowGroups * kRowsPer;    // 32 output rows an item
constexpr int kHaloH = kBand + 2;
constexpr int kFwdStages = 4;
constexpr int kMStages = 3;    // its stages carry dy too
constexpr int kMSub = 2;       // M: channel groups an item, sharing dy

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// A stage's halo box: kGroup channels x kHaloH rows x kBoxW columns of y in
// its dtype, starting at row r0-1 and at column c0-kLead, 16 bytes before
// the tile (TMA faults on a box whose first column is not 16-byte aligned),
// so column c0+j sits at box column kLead+j; kBoxW reaches column c0+kTileW
// and is a multiple of 16 bytes (TMA's rule for the inner box dimension).
template <typename T>
struct Box {
  static constexpr int kGroup = sizeof(T) == 2 ? 4 : 2;
  static constexpr int kLead = 16 / sizeof(T);
  static constexpr int kBoxW =
      (kLead + kTileW + 1 + kLead - 1) / kLead * kLead;   // 144 or 136
  static constexpr int kBytes = kGroup * kHaloH * kBoxW * sizeof(T);
  static_assert(kBytes % 16 == 0, "s*k follows the box in 16-byte reads");
  // forward stage: the box, then s*k of its channels (fp32 [kGroup][9])
  static constexpr int kFwdStage = align128(kBytes + kGroup * 9 * 4);
  // M stage: the box, then the dy tile (fp32 [kBand][kTileW])
  static constexpr int kDyOffset = align128(kBytes);
  static constexpr int kDyBytes = kBand * kTileW * 4;
  static constexpr int kMStage = kDyOffset + kDyBytes;
  // + 128 to align the ring
  static constexpr int kFwdSmem = kFwdStages * kFwdStage + 128;
  static constexpr int kMSmem = kMStages * kMStage + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x0, int x1,
                                            int x2, int x3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0),
      "r"(x1), "r"(x2), "r"(x3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x0, int x1,
                                            int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0),
      "r"(x1), "r"(x2)
      : "memory");
}

// the consumer warps only (named barrier 1; the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// values j .. j+3 (j odd) of a box row as fp32, from the three aligned
// pairs j-1 .. j+4: 32-bit reads of bf16 pairs (a bf16 is the top half of
// its fp32), or float2 reads
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int j,
                                      float (&v)[4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + j - 1);
  const uint32_t a = w[0], b = w[1], c = w[2];
  v[0] = __uint_as_float(a & 0xffff0000u);
  v[1] = __uint_as_float(b << 16);
  v[2] = __uint_as_float(b & 0xffff0000u);
  v[3] = __uint_as_float(c << 16);
}

__device__ __forceinline__ void load4(const float* row, int j, float (&v)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(row + j - 1);
  const float2 b = *reinterpret_cast<const float2*>(row + j + 1);
  const float2 c = *reinterpret_cast<const float2*>(row + j + 3);
  v[0] = a.y;
  v[1] = b.x;
  v[2] = b.y;
  v[3] = c.x;
}

__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 127) & ~static_cast<uintptr_t>(127));
}

// The work of one stage for the consumer thread that owns columns
// c0+2*pair, +1 of rows row0 .. row0+3 of the band: for each channel ch of
// the box, each of the 6 halo rows it touches is read once (4 values) and
// fed to every output row and tap that uses it, f(ch, p, tap, a, b) with a
// and b the values under column 2*pair and 2*pair+1.
template <typename T, typename F>
__device__ __forceinline__ void walk_box(const T* box, int pair, int row0,
                                         F&& f) {
  constexpr int kG = Box<T>::kGroup;
  constexpr int kW = Box<T>::kBoxW;
#pragma unroll
  for (int ch = 0; ch < kG; ++ch) {
#pragma unroll
    for (int rr = 0; rr < kRowsPer + 2; ++rr) {
      float v[4];
      // columns c0+2*pair-1 .. +2
      load4(box + (ch * kHaloH + row0 + rr) * kW, Box<T>::kLead + 2 * pair - 1,
            v);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int p = rr - dh;   // output row row0+p reads halo row p+dh
        if (p >= 0 && p < kRowsPer) {
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) f(ch, p, dh * 3 + dw, v[dw], v[dw + 1]);
        }
      }
    }
  }
}

template <typename TY, typename TS>
__global__ void __launch_bounds__(kThreads, 2)
    head_fwd_tma_kernel(const __grid_constant__ CUtensorMap ymap,
                        const TS* __restrict__ s, const float* __restrict__ k,
                        float* __restrict__ out, int B, int C, int H, int W) {
  using Bx = Box<TY>;
  constexpr int kG = Bx::kGroup;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = ring_base(smem_raw);
  __shared__ __align__(8) uint64_t full[kFwdStages], empty[kFwdStages];
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int per_sample = ((H + kBand - 1) / kBand) * tiles_w;
  const int items = B * per_sample;
  const int groups = (C + kG - 1) / kG;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(&full[i], 32);        // the producer warp's lanes (+ bytes)
      mbar_init(&empty[i], kWarps);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the one block-wide barrier: before the roles split

  int stage = 0;
  uint32_t phase = 0;
  if (warp == kWarps) {
    // producer: the box of each channel group of each item, and s*k of
    // its channels (0 past C, where TMA fills the box with zeros)
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / per_sample;
      const int rem = item - b * per_sample;
      const int r0 = (rem / tiles_w) * kBand;
      const int c0 = (rem % tiles_w) * kTileW;
      for (int gi = 0; gi < groups; ++gi) {
        const int cb = gi * kG;
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * Bx::kFwdStage;
        if (lane == 0) {
          // the box first, so that the loads of s and k below do not delay it
          mbar_arrive_tx(&full[stage], Bx::kBytes);
          tma_load_4d(st, &ymap, &full[stage], c0 - Bx::kLead, r0 - 1, cb,
                      b);
        } else {
          float* sk = reinterpret_cast<float*>(st + Bx::kBytes);
          for (int i = lane - 1; i < kG * 9; i += 31) {
            const int c = cb + i / 9;
            sk[i] = c < C ? to_float(s[static_cast<int64_t>(b) * C + c]) *
                                k[c * 9 + i % 9]
                          : 0.0f;
          }
          mbar_arrive(&full[stage]);
        }
        if (++stage == kFwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int pair = threadIdx.x % kPairs;
  const int row0 = (threadIdx.x / kPairs) * kRowsPer;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / per_sample;
    const int rem = item - b * per_sample;
    const int r0 = (rem / tiles_w) * kBand;
    const int c0 = (rem % tiles_w) * kTileW;
    float acc[kRowsPer][2];
#pragma unroll
    for (int p = 0; p < kRowsPer; ++p) acc[p][0] = acc[p][1] = 0.0f;
    for (int gi = 0; gi < groups; ++gi) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * Bx::kFwdStage;
      const float* sk = reinterpret_cast<const float*>(st + Bx::kBytes);
      float w[kG][9];   // 16-byte reads: the box's size is a multiple of 16
#pragma unroll
      for (int i = 0; i < kG * 9 / 4; ++i) {
        const float4 q = reinterpret_cast<const float4*>(sk)[i];
        w[(4 * i) / 9][(4 * i) % 9] = q.x;
        w[(4 * i + 1) / 9][(4 * i + 1) % 9] = q.y;
        w[(4 * i + 2) / 9][(4 * i + 2) % 9] = q.z;
        w[(4 * i + 3) / 9][(4 * i + 3) % 9] = q.w;
      }
#pragma unroll
      for (int i = kG * 9 / 4 * 4; i < kG * 9; ++i) w[i / 9][i % 9] = sk[i];
      walk_box(reinterpret_cast<const TY*>(st), pair, row0,
               [&](int ch, int p, int tap, float a, float c) {
                 acc[p][0] = fmaf(a, w[ch][tap], acc[p][0]);
                 acc[p][1] = fmaf(c, w[ch][tap], acc[p][1]);
               });
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kFwdStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // W is even on this path, so a column pair is inside or outside whole
    const int gc = c0 + 2 * pair;
    if (gc < W) {
#pragma unroll
      for (int p = 0; p < kRowsPer; ++p) {
        const int gr = r0 + row0 + p;
        if (gr < H) {
          *reinterpret_cast<float2*>(
              out + (static_cast<int64_t>(b) * H + gr) * W + gc) =
              make_float2(acc[p][0], acc[p][1]);
        }
      }
    }
  }
}

template <typename TY>
__global__ void __launch_bounds__(kThreads, 1)
    head_m_tma_kernel(const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap dymap,
                      float* __restrict__ m, int B, int C, int H, int W) {
  using Bx = Box<TY>;
  constexpr int kG = Bx::kGroup;
  constexpr int kItemG = kMSub * kG;   // channels an item
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = ring_base(smem_raw);
  __shared__ __align__(8) uint64_t full[kMStages], empty[kMStages];
  __shared__ float partial[kWarps][kItemG * 9];
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles = ((H + kBand - 1) / kBand) * tiles_w;
  const int groups = (C + kItemG - 1) / kItemG;
  const int items = B * groups;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMStages; ++i) {
      mbar_init(&full[i], 1);         // the producer's arrival (+ bytes)
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp == kWarps) {
    // producer: for every tile of the plane in order, the boxes of the
    // item's kMSub channel groups, the first with the tile's dy
    if (lane == 0) {
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / groups;
        const int cb = (item - b * groups) * kItemG;
        for (int t = 0; t < tiles; ++t) {
          const int r0 = (t / tiles_w) * kBand;
          const int c0 = (t % tiles_w) * kTileW;
          for (int sub = 0; sub < kMSub; ++sub) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = ring + stage * Bx::kMStage;
            mbar_arrive_tx(&full[stage],
                           Bx::kBytes + (sub == 0 ? Bx::kDyBytes : 0));
            tma_load_4d(st, &ymap, &full[stage], c0 - Bx::kLead, r0 - 1,
                        cb + sub * kG, b);
            if (sub == 0) {
              tma_load_3d(st + Bx::kDyOffset, &dymap, &full[stage], c0, r0,
                          b);
            }
            if (++stage == kMStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  const int pair = threadIdx.x % kPairs;
  const int row0 = (threadIdx.x / kPairs) * kRowsPer;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / groups;
    const int cb = (item - b * groups) * kItemG;
    float acc[kItemG][9];
#pragma unroll
    for (int i = 0; i < kItemG * 9; ++i) acc[i / 9][i % 9] = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      float d[kRowsPer][2];
#pragma unroll
      for (int sub = 0; sub < kMSub; ++sub) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * Bx::kMStage;
        if (sub == 0) {   // the tile's dy, kept for the other groups
          const float* dyt =
              reinterpret_cast<const float*>(st + Bx::kDyOffset);
#pragma unroll
          for (int p = 0; p < kRowsPer; ++p) {
            const float2 q = *reinterpret_cast<const float2*>(
                dyt + (row0 + p) * kTileW + 2 * pair);
            d[p][0] = q.x;
            d[p][1] = q.y;
          }
        }
        walk_box(reinterpret_cast<const TY*>(st), pair, row0,
                 [&](int ch, int p, int tap, float a, float c) {
                   float& s = acc[sub * kG + ch][tap];
                   s = fmaf(a, d[p][0], s);
                   s = fmaf(c, d[p][1], s);
                 });
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kMStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // fixed-order reduction: lanes by shuffle, then warps in index order
#pragma unroll
    for (int i = 0; i < kItemG * 9; ++i) {
      float v = acc[i / 9][i % 9];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) partial[warp][i] = v;
    }
    consumers_sync();
    if (threadIdx.x < kItemG * 9) {
      const int g = threadIdx.x / 9;
      const int tap = threadIdx.x - g * 9;
      float total = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) total += partial[wi][threadIdx.x];
      if (cb + g < C) {
        m[(static_cast<int64_t>(b) * 9 + tap) * C + cb + g] = total;
      }
    }
    consumers_sync();   // partial is read before the next item writes it
  }
}

}  // namespace tma

// TMA takes a y (and a dy) whose base is 16-byte aligned and whose rows are
// a multiple of 16 bytes apart (the tensor map's stride rule).
bool tma_rows(const void* y, const void* dy, int W, int y_dtype) {
  const int64_t row_bytes = static_cast<int64_t>(W) * (y_dtype == 1 ? 2 : 4);
  return reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         (dy == nullptr || reinterpret_cast<uintptr_t>(dy) % 16 == 0) &&
         row_bytes % 16 == 0;
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query, so the library links against the runtime alone
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled map of a row-major tensor of `rank` dims (innermost first) with
// zero fill outside it.
cudaError_t make_map(CUtensorMap* map, const void* base, bool bf16, int rank,
                     const cuuint64_t* dims, const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = bf16 ? 2 : 4;
  cuuint64_t strides[4];   // bytes, of dims 1 .. rank-1
  cuuint64_t stride = es;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      rank, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The persistent grid: CTAs the card holds at once for `kernel` with
// `smem` bytes of dynamic shared memory, read once per kernel and device.
cudaError_t resident_ctas(const void* kernel, int smem, int device,
                          int* ctas) {
  struct Entry {
    const void* kernel;
    int device;
    int ctas;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    if (cache[i].kernel == kernel && cache[i].device == device) {
      *ctas = cache[i].ctas;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      tma::kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  if (n < 64) cache[n++] = {kernel, device, *ctas};
  return cudaSuccess;
}

template <typename TY, typename TS>
cudaError_t launch_fwd_tma(const void* y, const void* s, const float* k,
                           float* out, int B, int C, int H, int W, int device,
                           cudaStream_t stream) {
  using Bx = tma::Box<TY>;
  CUtensorMap ymap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(B)};
  const cuuint32_t box[4] = {Bx::kBoxW, tma::kHaloH, Bx::kGroup, 1};
  cudaError_t err = make_map(&ymap, y, sizeof(TY) == 2, 4, dims, box);
  if (err != cudaSuccess) return err;
  auto kernel = tma::head_fwd_tma_kernel<TY, TS>;
  int ctas = 0;
  err = resident_ctas(reinterpret_cast<const void*>(kernel), Bx::kFwdSmem,
                      device, &ctas);
  if (err != cudaSuccess) return err;
  const int64_t items = static_cast<int64_t>(B) *
                        ((H + tma::kBand - 1) / tma::kBand) *
                        ((W + tma::kTileW - 1) / tma::kTileW);
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < ctas ? items : ctas);
  kernel<<<grid, tma::kThreads, Bx::kFwdSmem, stream>>>(
      ymap, static_cast<const TS*>(s), k, out, B, C, H, W);
  return cudaGetLastError();
}

template <typename TY>
cudaError_t launch_m_tma(const void* y, const float* dy, float* m, int B,
                         int C, int H, int W, int device, cudaStream_t stream) {
  using Bx = tma::Box<TY>;
  CUtensorMap ymap, dymap;
  const cuuint64_t ydims[4] = {static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(B)};
  const cuuint32_t ybox[4] = {Bx::kBoxW, tma::kHaloH, Bx::kGroup, 1};
  cudaError_t err = make_map(&ymap, y, sizeof(TY) == 2, 4, ydims, ybox);
  if (err != cudaSuccess) return err;
  const cuuint64_t ddims[3] = {static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(B)};
  const cuuint32_t dbox[3] = {tma::kTileW, tma::kBand, 1};
  err = make_map(&dymap, dy, false, 3, ddims, dbox);
  if (err != cudaSuccess) return err;
  auto kernel = tma::head_m_tma_kernel<TY>;
  int ctas = 0;
  err = resident_ctas(reinterpret_cast<const void*>(kernel), Bx::kMSmem,
                      device, &ctas);
  if (err != cudaSuccess) return err;
  constexpr int kItemG = tma::kMSub * Bx::kGroup;
  const int64_t items = static_cast<int64_t>(B) * ((C + kItemG - 1) / kItemG);
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < ctas ? items : ctas);
  kernel<<<grid, tma::kThreads, Bx::kMSmem, stream>>>(ymap, dymap, m, B, C,
                                                       H, W);
  return cudaGetLastError();
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
  if (tma_rows(y, nullptr, W, y_dtype)) {
    if (y_dtype == 1 && s_dtype == 1) {
      err = launch_fwd_tma<__nv_bfloat16, __nv_bfloat16>(y, s, k, out, B, C, H,
                                                         W, device, st);
    } else if (y_dtype == 1) {
      err = launch_fwd_tma<__nv_bfloat16, float>(y, s, k, out, B, C, H, W,
                                                 device, st);
    } else if (s_dtype == 1) {
      err = launch_fwd_tma<float, __nv_bfloat16>(y, s, k, out, B, C, H, W,
                                                 device, st);
    } else {
      err = launch_fwd_tma<float, float>(y, s, k, out, B, C, H, W, device, st);
    }
    return static_cast<int>(err);
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
  if (tma_rows(y, dy, W, y_dtype)) {
    err = y_dtype == 1
              ? launch_m_tma<__nv_bfloat16>(y, dy, m, B, C, H, W, device, st)
              : launch_m_tma<float>(y, dy, m, B, C, H, W, device, st);
    return static_cast<int>(err);
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

// 1 where the entry points take the TMA path for this y (and dy, for M;
// nullptr for the forward), else 0: the rule the wrapper counts paths by
extern "C" int betavae_head_tma_path(const void* y, const void* dy, int W,
                                     int y_dtype) {
  return tma_rows(y, dy, W, y_dtype) ? 1 : 0;
}
