// Fused SAME conv3d, kernel (3,3,3), dilation (1,d,d), optional ReLU, in
// float32, channels-last — the 3D feature head of the refinement detector.
//
// Replaces the TPU kernel cet_pick_tpu/ops/pallas_head.py:95
// (ztap_dilated_conv, Pallas body _kernel at :52). Same function, same
// signature at the Python wrapper (ops/ztap_conv.py):
//   x (B, D, H, W, C), k (3, 3, 3, C, F) -> y (B, D, H, W, F)
//   y[b,z,h,w,f] = sum_{kz,ky,kx,c} x[b, z+kz-1, h+(ky-1)d, w+(kx-1)d, c]
//                                   * k[kz,ky,kx,c,f]     (zero outside)
//
// What bounds it on this card. One layer does 2*27*C*F FLOP per output
// pixel against x read once and y written once: at the unet_N main-path
// shape, (4, 70, 256, 256), C = F = 32, 1.0e12 FLOP against 1.2 GB in and
// out; at the unetw_N shape, (4, 70, 128, 128), C = F = 128, 4.1e12 FLOP
// against 4.7 GB (1.4 ms at 3.35 TB/s). Operations bind: 15 / 58 ms in
// f32 FMA on the CUDA cores (67 TFLOP/s), 6 / 23 ms as 3xTF32 products on
// the tensor cores (495 / 3 TFLOP/s). This design is bound by instruction
// issue: per mma it spends ~3 instructions on fragment loads, tf32 splits
// and the promotion add.
//
// What the design does about it: an implicit GEMM on the tensor cores in
// 3xTF32 (tf32x3.cuh), which keeps f32 accuracy (~2^-21 relative per
// product) at up to 495 / 3 TFLOP/s:
//   * M = output pixels, N = F, K = 27 C. One block owns a tile of TH x 32
//     output pixels of one (b, z) slice and ALL of its F outputs (F <= 128;
//     wider F is cut into groups of 128, 64 or 32 on a grid axis), so x is
//     read once per launch through L2. Each warp owns 2 rows x 32 pixels
//     (four m16 tiles) x 32 outputs (four n8 tiles): 64 f32 accumulators a
//     thread, in registers. 8 warps a block (two blocks an SM), 16 at
//     F = 128 (one block an SM), whose tile of 8 x 32 pixels halves the
//     weight slabs staged per output pixel.
//   * K is walked in one fixed order: (kz, 8-channel chunk, ky, kx, c).
//     Per (kz, chunk) step the block stages, with cp.async into a
//     two-stage ring, the input rows its nine (ky, kx) taps need — the tile
//     plus a +-d pixel halo, 8 channels a pixel — and the 9 x 8 x F weight
//     slab (rows padded to F + 4 floats, so that a B fragment's rows 2t and
//     2t + 1 hit 32 distinct banks). All nine taps are then served from
//     shared memory: a tap only moves the A rows' origin by (ky d, kx d)
//     pixels, which any register fragment takes (mma.sync loads A per
//     lane, so no 8-row core-matrix grid to meet); a lane's two channels
//     of a pixel, 2t and 2t + 1, load as one float2, and the 16 lanes of a
//     half warp read 4 consecutive pixels: no bank conflicts.
//   * Each tap's three products go into a fresh accumulator that is then
//     added to the output's sum (tf32x3.cuh, mma3_promote): the tensor
//     core truncates what it adds to a large accumulator.
//   * Channels past C (C = 44, 4, ...) and taps past the volume's x/y
//     borders are zero-filled by cp.async (exact zeros; a k8 step needs 8
//     channels); z taps past the volume are skipped for the whole block.
//   * Every output's sum runs in that K order whatever the tile or the z
//     window: no split-K, no atomics, so tiled == full and runs are
//     bit-identical.
// mma.sync.m16n8k8, not wgmma: every fragment comes from plain per-lane
// shared-memory loads, so the dilated taps' 4-pixel shifts and the
// padded tiles need no descriptor layout. wgmma would take A
// from registers but B only through a shared-memory descriptor, K-major
// in 8-row core matrices for tf32, a layout this design does not yet
// stage. That costs part of the tensor cores' rate: wgmma, TMA staging
// and a persistent schedule are later work.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kTileW = 32;     // output pixels along W per block
constexpr int kRowsPerWarp = 2;
constexpr int kMT = 4;         // m16 tiles a warp: 2 rows x 2 halves of 32
constexpr int kChunk = 8;      // channels per K step (the mma's k depth)
constexpr int kMaxDil = 8;

// Block geometry for FG outputs per block, WARPS warps, WN of them along
// the outputs.
template <int FG, int WN, int WARPS>
struct Geo {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kWM = WARPS / WN;           // warps along pixels
  static constexpr int kNW = FG / WN;              // outputs per warp
  static constexpr int kNT = kNW / 8;              // n8 tiles per warp
  static constexpr int kTileH = kRowsPerWarp * kWM;
  static constexpr int kLdW = FG + 4;              // weight row stride
  static constexpr int kWFloats = 9 * kChunk * kLdW;
};

template <int FG, int WN, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, WARPS <= 8 ? 2 : 1)
ztap_conv_kernel(const float* __restrict__ x, const float* __restrict__ k,
                 float* __restrict__ y, int D, int H, int W, int C, int F,
                 int dil, int tiles_w, int tiles_h, int relu) {
  using G = Geo<FG, WN, WARPS>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int hc = kTileW + 2 * dil;                 // halo columns
  const int hp = (G::kTileH + 2 * dil) * hc;       // halo pixels
  const int stage_floats = hp * 8 + G::kWFloats;

  const long long tiles = (long long)tiles_w * tiles_h;
  const int tile = (int)(blockIdx.x % tiles);
  const long long bz = blockIdx.x / tiles;  // b * D + z
  const int z = (int)(bz % D);
  const long long b = bz / D;
  const int f0 = blockIdx.y * FG;
  const int ox0 = (tile % tiles_w) * kTileW;
  const int oy0 = (tile / tiles_w) * G::kTileH;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp / WN) * kRowsPerWarp;  // the warp's first tile row
  const int n0 = (warp % WN) * G::kNW;        // its first output in the group

  const int kz_lo = z > 0 ? 0 : 1;
  const int kz_hi = z < D - 1 ? 2 : 1;
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int n_steps = (kz_hi - kz_lo + 1) * n_chunks;

  // stage step s — (kz, chunk) — into ring slot `slot`
  auto load = [&](int s, int slot) {
    const int kz = kz_lo + s / n_chunks;
    const int c0 = (s % n_chunks) * kChunk;
    float* xs = smem + slot * stage_floats;
    float* ws = xs + hp * 8;
    const float* xz = x + (size_t)(b * D + z + kz - 1) * H * W * C;
    for (int i = threadIdx.x; i < hp * 2; i += G::kThreads) {
      const int p = i >> 1, half = i & 1;
      const int iy = oy0 - dil + p / hc, ix = ox0 - dil + p % hc;
      const int c = c0 + 4 * half;
      const bool v = iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
      const float* src = v ? xz + ((size_t)iy * W + ix) * C + c : x;
      tf32x3::cp_async16(xs + p * 8 + 4 * half, src, v);
    }
    constexpr int kRow4 = FG / 4;  // 16-byte pieces per weight row
    for (int i = threadIdx.x; i < 9 * kChunk * kRow4; i += G::kThreads) {
      const int row = i / kRow4, j = i % kRow4;  // row = tap * 8 + c
      const int c = c0 + row % kChunk;
      const bool v = c < C;
      const float* src =
          v ? k + (((size_t)kz * 9 + row / kChunk) * C + c) * F + f0 + 4 * j
            : k;
      tf32x3::cp_async16(ws + row * G::kLdW + 4 * j, src, v);
    }
  };

  float acc[kMT][G::kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < G::kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  load(0, 0);
  tf32x3::cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) load(s + 1, (s + 1) & 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // step s has landed (this thread's part)
    __syncthreads();             // ... and every other thread's
    const float* xs = smem + (s & 1) * stage_floats;
    const float* ws = xs + hp * 8;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      FragB bf[G::kNT];
      const float* wt = ws + tap * kChunk * G::kLdW + n0 + g;
#pragma unroll
      for (int n = 0; n < G::kNT; ++n)  // k = t, t + 4: channels 2t, 2t + 1
        bf[n] = tf32x3::split_b(wt[2 * t * G::kLdW + 8 * n],
                                wt[(2 * t + 1) * G::kLdW + 8 * n]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        // rows g and g + 8 of the m tile: output pixels (r, cb + g [+ 8])
        // read halo pixel (r + ky d, cb + g [+ 8] + kx d)
        const int r = r0 + m / 2, cb = (m % 2) * 16;
        const int p = (r + ky * dil) * hc + cb + kx * dil + g;
        const float2 lo = *reinterpret_cast<const float2*>(xs + p * 8 + 2 * t);
        const float2 hi =
            *reinterpret_cast<const float2*>(xs + (p + 8) * 8 + 2 * t);
        const FragA af = tf32x3::split_a(lo.x, hi.x, lo.y, hi.y);
#pragma unroll
        for (int n = 0; n < G::kNT; ++n)
          tf32x3::mma3_promote(acc[m][n], af, bf[n]);
      }
    }
    __syncthreads();  // slot s & 1 is consumed before step s + 2 refills it
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int oy = oy0 + r0 + m / 2;
    if (oy >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + (m % 2) * 16 + g + 8 * h;
      if (ox >= W) continue;
      float* dst = y + ((size_t)bz * H * W + (size_t)oy * W + ox) * F + f0 +
                   n0 + 2 * t;
#pragma unroll
      for (int n = 0; n < G::kNT; ++n) {
        float2 o = make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        if (relu) {
          o.x = fmaxf(o.x, 0.f);
          o.y = fmaxf(o.y, 0.f);
        }
        *reinterpret_cast<float2*>(dst + 8 * n) = o;
      }
    }
  }
}

template <int FG, int WN, int WARPS>
int launch(const float* x, const float* k, float* y, int B, int D, int H,
           int W, int C, int F, int dil, int relu, cudaStream_t stream) {
  using G = Geo<FG, WN, WARPS>;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + G::kTileH - 1) / G::kTileH;
  const long long blocks = (long long)tiles_w * tiles_h * B * D;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int hp = (G::kTileH + 2 * dil) * (kTileW + 2 * dil);
  const size_t smem = 2 * ((size_t)hp * 8 + G::kWFloats) * sizeof(float);
  auto kernel = ztap_conv_kernel<FG, WN, WARPS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)blocks, (unsigned)(F / FG));
  kernel<<<grid, G::kThreads, smem, stream>>>(x, k, y, D, H, W, C, F, dil,
                                              tiles_w, tiles_h, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous, 16-byte aligned float32 tensors; the stream is PyTorch's
// current stream. The function only launches: it allocates nothing and
// does not synchronize. Takes C % 4 == 0, F = 16 or a multiple of 32, and
// 1 <= dil <= 8. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ztap_dilated_conv_f32(const void* x, const void* k, void* y,
                                     int B, int D, int H, int W, int C, int F,
                                     int dil, int relu, int device,
                                     void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 4 || C % 4 != 0 || F < 16 || F > 65535 * 32 || dil < 1 ||
      dil > kMaxDil)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* kp = static_cast<const float*>(k);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 128 == 0)
    return launch<128, 4, 16>(xp, kp, yp, B, D, H, W, C, F, dil, relu, s);
  if (F % 64 == 0)
    return launch<64, 2, 8>(xp, kp, yp, B, D, H, W, C, F, dil, relu, s);
  if (F % 32 == 0)
    return launch<32, 1, 8>(xp, kp, yp, B, D, H, W, C, F, dil, relu, s);
  if (F == 16)
    return launch<16, 1, 8>(xp, kp, yp, B, D, H, W, C, F, dil, relu, s);
  return (int)cudaErrorInvalidValue;
}
