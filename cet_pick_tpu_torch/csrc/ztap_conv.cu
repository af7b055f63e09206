// Fused SAME conv3d, kernel (3,3,3), dilation (1,d,d), optional ReLU, in
// float32 (ztap_dilated_conv_f32) or bfloat16 (ztap_dilated_conv_bf16, at
// the end of this file), channels-last — the 3D feature head of the
// refinement detector.
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

#include <cuda.h>  // CUtensorMap (the driver is reached through cudart)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// bfloat16: x (B, D, H, W, C) bf16, the kernel in bf16 packed by the
// wrapper as the kernel stages it (ztap_dilated_conv_bf16_plan), y bf16.
//
// The rounding points are JAX's under --dtype bfloat16 (pallas_head.py:86-92,
// detector.py:66-79): each z offset's 9 C products are summed in f32 and
// rounded to bf16 (u0, u1, u2), then y = bf16(bf16(u0 + u1) + u2), then the
// ReLU. Each z offset's products run in one fixed order into f32 sums;
// when a z offset is complete its sums are rounded and folded into the
// output's running bf16 sum, u0 first. A z offset past the
// volume adds an exact zero, as JAX's zero pad does. No split-K and no
// atomics: every output has one owner and one order, so launches are
// bit-identical and tiled == full.
//
// What bounds it: 2*27*C*F FLOP per output pixel against 2 bytes a channel
// in and out. At (4, 70, 256, 256), C = F = 32: 1.0e12 FLOP (1.0 ms on the
// bf16 tensor cores at 989 TFLOP/s) against 0.59 GB (0.18 ms at 3.35 TB/s);
// at (4, 70, 128, 128), C = F = 128: 4.1e12 FLOP (4.1 ms) against 2.3 GB.
// Operations bind. An earlier design (the float32 kernel's tile and
// cp.async staging with mma.sync.m16n8k16) reached 19-22% of that bound:
// each block of 8 x 32 pixels staged all 27 C F weights and three halos of
// its own (~25 GB through L2 at C = F = 128) through a two-stage ring with
// two block barriers a step, and mma.sync does not reach Hopper's
// tensor-core rate.
//
// What this design does about it (hopper.cuh has the pieces):
//   * wgmma m64nNk16, bf16 in, f32 accumulate, both operands read from
//     shared memory through descriptors; a 64-pixel row of output is one M.
//   * The dilated shift. A tap (ky, kx) moves the A rows by (ky d, kx d)
//     pixels, not a multiple of a swizzle atom's 8 rows. x is staged by TMA
//     in boxes of 32 channels, 64-byte swizzled: one 64-byte row a pixel,
//     the box's pixels in order. The swizzle is a function of the absolute
//     shared address, TMA's and wgmma's alike (descriptor base offset 0),
//     so the A of a tap starts at any pixel of its halo row and the second
//     k16 step of the 32 channels 32 bytes on (desc_sw64): route (ii) with
//     wide rows. Boxes with 16-byte rows (unswizzled planes of 8 channels)
//     staged at about a quarter of this rate: TMA's cost goes by the row.
//   * The weights are packed by the wrapper in the order a stage reads
//     them, so a stage's weights are one bulk copy; B is K-major and
//     unswizzled: planes of 8 channels, rows of 16 bytes, SBO 128.
//   * One producer warpgroup (one thread issues the copies; setmaxnreg 40)
//     and two consumer warpgroups (setmaxnreg 232), a ring of 2-4 stages
//     (as many as fit in 227 KB) with full / empty mbarriers; a block an
//     SM walks its tiles in order, so the next tile's loads overlap the
//     last one's fold and stores. A consumer issues a stage's wgmmas in
//     commit groups, waits for each and then releases the slot (each warp
//     arrives on the empty barrier); the other consumer keeps the tensor
//     cores busy meanwhile. The dilation passes through an empty asm in
//     each step, so the compiler recomputes the descriptors' offsets there
//     instead of holding 9 MT of them in registers (they spilled).
//   * The tensor core truncates what it adds to a large accumulator (the
//     float32 kernel's mma3_promote, tf32x3.cuh): with all 72 k16 steps of
//     a z offset at C = 128 in one accumulator, an output that cancels to
//     ~1e-6 landed ten of its rounding allowances from the plain version.
//     So each stage's products of one m64 row go into a fresh accumulator,
//     one commit group a row, and are added to the z offset's f32 sums in
//     registers (the walk's first 32 channels go straight into the sums:
//     at C = 32 they are the whole z offset).
//   * Two tilings, chosen from C, F and d by plan_for:
//     - "walk" (F <= 32, where its weights stay resident): JAX's own form.
//       A block owns 4 rows x 64 pixels of a run of up to 16 output slices
//       and stages each input slice once, (4 + 2d) x (64 + 2d) pixels; one
//       product with N = 3 FN (the three z offsets' outputs side by side,
//       K = 9 C) gives u2 of slice s - 1, u1 of s and u0 of s + 1, folded in
//       that order into two pending sums; the 9 C x 3 FN weights are loaded
//       once a block. x is read (4 + 2d) / 4 x 72 / 64 times per run.
//     - "out" (F > 32): a tile is TH x 64 pixels of one output slice and N
//       outputs (N = 8 .. 128 covers F, wider F in groups of 128); a stage
//       is (kz, ky, 32 channels): TH halo rows and 3 x N x 32 weights, 6
//       k16 steps a row. TH = 8 at N <= 64, 4 above: the f32 sums of
//       MT = TH / 2 rows a consumer and the fresh accumulator take
//       (MT + 1) N / 2 <= 192 of its 232 registers; the running bf16 sums
//       live in shared memory, a word a thread apart.
//   Any F >= 1 (weight rows past F are zeros, outputs past F not stored),
//   C % 8 == 0 (TMA's 16-byte strides; channels past C are TMA's zero
//   fill, as are pixels past the volume's x / y borders), 1 <= d <= 8.
// Sums of up to 9 C products stay in the tensor core's accumulator (its
// truncation costs ~2^-23 of the sum a step, far below bf16's 2^-9
// rounding), so the result is the bf16 rounding of an f32 sum taken in
// another order than the plain version's: bit-equal on most elements, one
// bf16 ulp of a rounded term off on the rest (ops/ztap_conv.bf16_agreement).

// the two floats of a packed bf16 pair (low half first)
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// round two floats to bf16 (to nearest even) and pack them, low half first
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// s = bf16(s + bf16(a)) for a packed pair s and two f32 sums a: one z
// offset's plane rounded, then added to the running sum and rounded (the
// sum of two bf16 values is exact in f32, so this is bf16's own add)
__device__ __forceinline__ uint32_t fold_bf16x2(uint32_t s, float a0,
                                                float a1) {
  const float2 u = unpack_bf16x2(pack_bf16x2(a0, a1));
  const float2 r = unpack_bf16x2(s);
  return pack_bf16x2(r.x + u.x, r.y + u.y);
}

namespace zb {

constexpr int kTW = 64;         // output pixels along W of a tile: one M
constexpr int kCX = 32;         // channels of an x box: 64 bytes a pixel
constexpr int kConsumers = 2;   // consumer warpgroups a block
constexpr int kThreads = 128 * (1 + kConsumers);  // and one producer
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // a block's opt-in shared memory
constexpr int kAlign = 1024;      // TMA's swizzled boxes
constexpr int kBarBytes = 8 * (2 * kMaxStages + 1);
constexpr int kRun = 16;          // output slices of a walk unit, at most
constexpr int kWidths[] = {8, 16, 32, 48, 64, 96, 128};  // "out" N

__host__ __device__ constexpr uint32_t align_up(uint32_t v, uint32_t a) {
  return (v + a - 1) / a * a;
}

// "out": a tile is TH rows x 64 pixels of one output slice and N outputs,
// MT rows a consumer; "walk": TH = 4 rows x 64 pixels walking a run of
// slices, N = 3 FN (the three z offsets' outputs side by side), MT = 2.
__host__ __device__ constexpr int out_mt(int n) { return n <= 64 ? 4 : 2; }
constexpr int kWalkMT = 2;
template <int N>
struct Out {
  static constexpr int kMT = out_mt(N);
  static constexpr int kTH = kConsumers * kMT;
};
template <int FN>
struct Walk {
  static constexpr int kN = 3 * FN;
  static constexpr int kMT = kWalkMT;
  static constexpr int kTH = kConsumers * kMT;
};

// What a launch needs besides the x map. Shared memory: `resident` bytes
// (the walk's weights, or the out tiling's running bf16 sums), `stages`
// ring stages of `stage` bytes (the x box, `xbytes` padded to `xspan`,
// then the out tiling's weights, `wbytes`), then the barriers.
struct Args {
  const __nv_bfloat16* w;  // the weights packed as the kernel stages them
  __nv_bfloat16* y;
  int B, D, H, W, F, chunks, dil, relu;
  int tiles_w, tiles_h, run, runs, units, stages;
  uint32_t xbytes, xspan, wbytes, stage, resident;
};

// Host plan of a launch: which design, its width, tile rows, and the
// shared memory it takes (stages < 2: it does not fit).
struct Plan {
  int walk, n, th, stages;
  uint32_t xbytes, xspan, wbytes, stage, resident;
  size_t smem;
};

Plan make_plan(int C, int F, int dil, bool walk) {
  Plan p{};
  const int chunks = (C + kCX - 1) / kCX, wh = kTW + 2 * dil;
  p.walk = walk;
  if (walk) {
    p.n = (F + 7) / 8 * 8;  // FN
    p.th = kConsumers * kWalkMT;
    p.xbytes = 64u * wh * (p.th + 2 * dil);
    p.wbytes = 0;
    p.resident = align_up(chunks * 2u * 2u * 9u * 3u * p.n * 16u, kAlign);
  } else {
    p.n = 128;  // wider F: groups of 128
    for (int n : kWidths)
      if (n >= F) {
        p.n = n;
        break;
      }
    p.th = kConsumers * out_mt(p.n);
    p.xbytes = 64u * wh * p.th;
    p.wbytes = 2u * 2u * 3u * p.n * 16u;
    // the consumers' running bf16 sums: MT x N / 4 words a thread
    p.resident = align_up(out_mt(p.n) * (p.n / 4) * 4u * 128 * kConsumers,
                          kAlign);
  }
  p.xspan = align_up(p.xbytes, kAlign);
  p.stage = align_up(p.xspan + p.wbytes, kAlign);
  const long long room = (long long)kSmemMax - kAlign - kBarBytes - p.resident;
  p.stages = room < 0 ? 0 : (int)std::min<long long>(kMaxStages, room / p.stage);
  p.smem = kAlign + p.resident + (size_t)p.stages * p.stage + kBarBytes;
  return p;
}

// The walk takes F <= 32 where its resident weights and two stages fit.
// (Built with ZTAP_BF16_OUT_ONLY, every F takes the out tiling:
// tools/ztap_bf16_tilings.py times the two against each other.)
Plan plan_for(int C, int F, int dil) {
#ifndef ZTAP_BF16_OUT_ONLY
  if (F <= 32) {
    const Plan p = make_plan(C, F, dil, true);
    if (p.stages >= 2) return p;
  }
#endif
  return make_plan(C, F, dil, false);
}

struct Ring {  // a slot of the stage ring and the parity of its phase
  int slot, stages;
  uint32_t phase;
  __device__ void next() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// one output pair (f, f + 1) of a pixel's row dst, ReLU'd, past F skipped
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, int f, int F,
                                           uint32_t o, int relu) {
  if (relu) {
    const float2 v = unpack_bf16x2(o);
    o = pack_bf16x2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));  // exact
  }
  if (f + 1 < F && F % 2 == 0) {
    *reinterpret_cast<uint32_t*>(dst + f) = o;
  } else {
    if (f < F) dst[f] = __ushort_as_bfloat16((uint16_t)(o & 0xffff));
    if (f + 1 < F) dst[f + 1] = __ushort_as_bfloat16((uint16_t)(o >> 16));
  }
}

// One output slice's rows of a tile from a consumer's registers:
// v[m][2 j + h] is tile row cw MT + m, pixel ox0 + 16 warp + g + 8 h,
// outputs f0 + 8 j + 2 t4 and + 1 (the accumulator's fragment layout).
template <int MT, int K>
__device__ __forceinline__ void store_rows(const uint32_t (&v)[MT][K],
                                           const Args& a, size_t slice,
                                           int oy0, int ox0, int f0,
                                           int cw) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int oy = oy0 + cw * MT + m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + 16 * warp + g + 8 * h;
      if (oy >= a.H || ox >= a.W) continue;
      __nv_bfloat16* dst =
          a.y + ((slice * a.H + oy) * a.W + ox) * a.F + f0;
#pragma unroll
      for (int j = 0; j < K / 2; ++j)
        store_pair(dst, 8 * j + 2 * t4, a.F - f0, v[m][2 * j + h], a.relu);
    }
  }
}

// the dilation, opaque to the compiler inside a loop: the 9 MT descriptor
// offsets it feeds are recomputed in each step, not hoisted into registers
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// ---- "out": one output slice a tile, K in (kz, ky, 32 channels, kx, k16)
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ztap_conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                      const Args a) {
  using G = Out<N>;
  extern __shared__ __align__(1024) uint8_t zb_smem[];
  const uint32_t base = align_up(hopper::smem_addr(zb_smem), kAlign);
  const uint32_t bars = base + a.resident + a.stages * a.stage;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };
  const auto xs = [&](int s) { return base + a.resident + s * a.stage; };
  const int BD = a.B * a.D;
  // unit -> (x tile, y tile, slice b*D + z, output group): x fastest
  const auto tile = [&](int u, int& ox0, int& oy0, int& bz, int& fg) {
    ox0 = (u % a.tiles_w) * kTW;
    u /= a.tiles_w;
    oy0 = (u % a.tiles_h) * G::kTH;
    u /= a.tiles_h;
    bz = u % BD;
    fg = u / BD;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 4 * kConsumers);  // every consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread loads
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&xmap);
      Ring r{0, a.stages, 0};
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        int ox0, oy0, bz, fg;
        tile(u, ox0, oy0, bz, fg);
        const int z = bz % a.D;
        for (int kz = z > 0 ? 0 : 1; kz <= (z < a.D - 1 ? 2 : 1); ++kz)
          for (int ky = 0; ky < 3; ++ky)
            for (int ch = 0; ch < a.chunks; ++ch) {
              hopper::mbar_wait(empty(r.slot), r.phase ^ 1);
              hopper::mbar_expect_tx(full(r.slot), a.xbytes + a.wbytes);
              hopper::tma_load_4d(xs(r.slot), &xmap, full(r.slot), ch * kCX,
                                  ox0 - a.dil, oy0 + (ky - 1) * a.dil,
                                  bz + kz - 1);
              const size_t st = ((size_t)(fg * 3 + kz) * 3 + ky) * a.chunks + ch;
              hopper::bulk_load(xs(r.slot) + a.xspan,
                                a.w + st * (a.wbytes / 2), a.wbytes,
                                full(r.slot));
              r.next();
            }
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int cw = threadIdx.x / 128 - 1;  // the consumer's rows: cw MT + m
  const int lane = threadIdx.x % 32;
  // each consumer thread's running bf16 sums in shared memory, word
  // (m N / 4 + i) of thread t at 4 (256 (m N / 4 + i) + t): no two threads
  // share a word or a bank
  uint32_t* const sums = reinterpret_cast<uint32_t*>(
                             zb_smem + (base - hopper::smem_addr(zb_smem))) +
                         (threadIdx.x - 128);
  const auto sum = [&](int m, int i) -> uint32_t& {
    return sums[(m * (N / 4) + i) * 128 * kConsumers];
  };
  float part[N / 2];          // one stage's products of one m64 row
  float run[G::kMT][N / 2];   // the z offset's f32 sums
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  Ring r{0, a.stages, 0};
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    int ox0, oy0, bz, fg;
    tile(u, ox0, oy0, bz, fg);
    const int z = bz % a.D;
#pragma unroll
    for (int m = 0; m < G::kMT; ++m)
#pragma unroll
      for (int i = 0; i < N / 4; ++i) sum(m, i) = 0u;
    for (int kz = z > 0 ? 0 : 1; kz <= (z < a.D - 1 ? 2 : 1); ++kz) {
#pragma unroll
      for (int m = 0; m < G::kMT; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) run[m][i] = 0.f;
      for (int ky = 0; ky < 3; ++ky)
        for (int ch = 0; ch < a.chunks; ++ch) {
          hopper::mbar_wait(full(r.slot), r.phase);
          const int d = opaque(a.dil), wh = kTW + 2 * d;
          const uint32_t xb = xs(r.slot), wb = xb + a.xspan;
#pragma unroll
          for (int m = 0; m < G::kMT; ++m) {
            hopper::fence_regs(part);
            hopper::wgmma_fence();
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                // weights [h][plane][kx][n][8 ch]; x [row][pixel][32 ch]
                const int q = (cw * G::kMT + m) * wh + kx * d;
                hopper::Wgmma<N>::run(
                    part, hopper::desc_sw64(xb + 64u * q + 32u * h),
                    hopper::desc_k_major(
                        wb + (uint32_t)((h * 2 * 3 + kx) * N * 16),
                        3 * N * 16, 128),
                    kx > 0 || h > 0);
              }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(part);
#pragma unroll
            for (int i = 0; i < N / 2; ++i) run[m][i] += part[i];
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(empty(r.slot));
          r.next();
        }
      // the z offset is complete: fold it into the running sums
#pragma unroll
      for (int m = 0; m < G::kMT; ++m)
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
          sum(m, i) = fold_bf16x2(sum(m, i), run[m][2 * i], run[m][2 * i + 1]);
    }
    uint32_t out[G::kMT][N / 4];
#pragma unroll
    for (int m = 0; m < G::kMT; ++m)
#pragma unroll
      for (int i = 0; i < N / 4; ++i) out[m][i] = sum(m, i);
    store_rows(out, a, bz, oy0, ox0, fg * N, cw);
  }
}

// ---- "walk": a run of slices a tile, each input slice staged once ---------
template <int FN>
__global__ void __launch_bounds__(kThreads, 1)
ztap_conv_bf16_walk_kernel(const __grid_constant__ CUtensorMap xmap,
                           const Args a) {
  using G = Walk<FN>;
  constexpr int N = G::kN, J = FN / 8;
  extern __shared__ __align__(1024) uint8_t zb_smem[];
  const uint32_t base = align_up(hopper::smem_addr(zb_smem), kAlign);
  const uint32_t bars = base + a.resident + a.stages * a.stage;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };
  const uint32_t kbar = bars + 8 * 2 * kMaxStages;
  const auto xs = [&](int s) { return base + a.resident + s * a.stage; };
  // unit -> (x tile, y tile, run, b): x fastest
  const auto tile = [&](int u, int& ox0, int& oy0, int& z0, int& b) {
    ox0 = (u % a.tiles_w) * kTW;
    u /= a.tiles_w;
    oy0 = (u % a.tiles_h) * G::kTH;
    u /= a.tiles_h;
    z0 = (u % a.runs) * a.run;
    b = u / a.runs;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 4 * kConsumers);
    }
    hopper::mbar_init(kbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&xmap);
      const uint32_t kbytes = a.chunks * 2u * 2u * 9u * N * 16u;
      hopper::mbar_expect_tx(kbar, kbytes);
      hopper::bulk_load(base, a.w, kbytes, kbar);
      Ring r{0, a.stages, 0};
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        int ox0, oy0, z0, b;
        tile(u, ox0, oy0, z0, b);
        const int s_hi = min(z0 + a.run, a.D - 1);
        for (int s = max(z0 - 1, 0); s <= s_hi; ++s)
          for (int ch = 0; ch < a.chunks; ++ch) {
            hopper::mbar_wait(empty(r.slot), r.phase ^ 1);
            hopper::mbar_expect_tx(full(r.slot), a.xbytes);
            hopper::tma_load_4d(xs(r.slot), &xmap, full(r.slot), ch * kCX,
                                ox0 - a.dil, oy0 - a.dil, b * a.D + s);
            r.next();
          }
      }
    }
    return;
  }

  hopper::regs_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  float part[N / 2];         // one stage's products of one m64 row
  float acc[G::kMT][N / 2];  // the slice's f32 sums
  // bf16 pairs of the two pending outputs: pa holds u0 + u1 of slice s - 1,
  // pb u0 of slice s, when slice s's products come in
  uint32_t pa[G::kMT][2 * J], pb[G::kMT][2 * J];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  hopper::mbar_wait(kbar, 0);
  Ring r{0, a.stages, 0};
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    int ox0, oy0, z0, b;
    tile(u, ox0, oy0, z0, b);
    const int z1 = min(z0 + a.run, a.D), s_hi = min(z1, a.D - 1);
#pragma unroll
    for (int m = 0; m < G::kMT; ++m)
#pragma unroll
      for (int i = 0; i < 2 * J; ++i) pa[m][i] = pb[m][i] = 0u;
    for (int s = max(z0 - 1, 0); s <= s_hi; ++s) {
      for (int ch = 0; ch < a.chunks; ++ch) {
        hopper::mbar_wait(full(r.slot), r.phase);
        const int d = opaque(a.dil), wh = kTW + 2 * d;
        const uint32_t xb = xs(r.slot);
        // the 18 k16 steps of one m64 row into `dst`, waited for
        const auto row = [&](auto& dst, int m) {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // resident weights [chunk][h][plane][tap][kz F + f][8 ch]
              const int q =
                  (cw * G::kMT + m + (tap / 3) * d) * wh + (tap % 3) * d;
              hopper::Wgmma<N>::run(
                  dst, hopper::desc_sw64(xb + 64u * q + 32u * h),
                  hopper::desc_k_major(
                      base + (uint32_t)((((ch * 2 + h) * 2 * 9) + tap) * N *
                                        16),
                      9 * N * 16, 128),
                  tap > 0 || h > 0);
            }
        };
        if (ch == 0) {  // the slice's first chunk: straight into its sums
#pragma unroll
          for (int m = 0; m < G::kMT; ++m) hopper::fence_regs(acc[m]);
          hopper::wgmma_fence();
#pragma unroll
          for (int m = 0; m < G::kMT; ++m) row(acc[m], m);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int m = 0; m < G::kMT; ++m) hopper::fence_regs(acc[m]);
        } else {  // later chunks: a fresh accumulator, added in f32
#pragma unroll
          for (int m = 0; m < G::kMT; ++m) {
            hopper::fence_regs(part);
            hopper::wgmma_fence();
            row(part, m);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(part);
#pragma unroll
            for (int i = 0; i < N / 2; ++i) acc[m][i] += part[i];
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty(r.slot));
        r.next();
      }
      // slice s is in: columns [kz FN, kz FN + FN) of acc are u_kz of
      // output s + 1 - kz. Output s - 1 is complete, s has u0 + u1, s + 1 u0.
      uint32_t done[G::kMT][2 * J];
#pragma unroll
      for (int m = 0; m < G::kMT; ++m)
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * j + h, e = 4 * j + 2 * h;
            done[m][i] = fold_bf16x2(pa[m][i], acc[m][e + 4 * 2 * J],
                                     acc[m][e + 4 * 2 * J + 1]);
            pa[m][i] = fold_bf16x2(pb[m][i], acc[m][e + 4 * J],
                                   acc[m][e + 4 * J + 1]);
            pb[m][i] = fold_bf16x2(0u, acc[m][e], acc[m][e + 1]);
          }
      if (s - 1 >= z0) store_rows(done, a, (size_t)b * a.D + s - 1, oy0, ox0, 0, cw);
    }
    if (z1 == a.D)  // the last slice's z + 1 offset is the zero pad
      store_rows(pa, a, (size_t)b * a.D + a.D - 1, oy0, ox0, 0, cw);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links only cudart)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x (B, D, H, W, C) as a tiled map over (B*D, H, W, C), innermost first:
// boxes of 32 channels x (64 + 2 dil) pixels x `rows` rows of one slice,
// 64-byte swizzled, zeros outside the tensor.
int encode_x(CUtensorMap* map, const void* x, int B, int D, int H, int W,
             int C, int dil, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B * D};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const cuuint32_t box[4] = {kCX, (cuuint32_t)(kTW + 2 * dil),
                             (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <typename K>
int launch(K kernel, const Plan& p, const void* x, const void* k, void* y,
           int B, int D, int H, int W, int C, int F, int dil, int relu,
           int device, cudaStream_t stream) {
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  Args a{};
  a.w = static_cast<const __nv_bfloat16*>(k);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B, a.D = D, a.H = H, a.W = W, a.F = F, a.dil = dil, a.relu = relu;
  a.chunks = (C + kCX - 1) / kCX;
  a.tiles_w = (W + kTW - 1) / kTW;
  a.tiles_h = (H + p.th - 1) / p.th;
  // walk units of `run` <= kRun output slices, as even as they come
  a.run = (D + (D + kRun - 1) / kRun - 1) / ((D + kRun - 1) / kRun);
  a.runs = p.walk ? (D + a.run - 1) / a.run : 1;
  const long long units = (long long)a.tiles_w * a.tiles_h * B *
                          (p.walk ? a.runs : (long long)D * ((F + p.n - 1) / p.n));
  if (units > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  a.units = (int)units;
  a.stages = p.stages;
  a.xbytes = p.xbytes, a.xspan = p.xspan, a.wbytes = p.wbytes;
  a.stage = p.stage, a.resident = p.resident;

  CUtensorMap xmap;
  int e = encode_x(&xmap, x, B, D, H, W, C, dil,
                   p.walk ? p.th + 2 * dil : p.th);
  if (e) return e;
  int sms = 0;
  e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e) return e;
  const int grid = (int)std::min<long long>(units, sms);
  kernel<<<grid, kThreads, p.smem, stream>>>(xmap, a);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* k, void* y, int B, int D, int H,
             int W, int C, int F, int dil, int relu, int device,
             cudaStream_t s) {
  const Plan p = plan_for(C, F, dil);
  const auto go = [&](auto kernel) {
    return launch(kernel, p, x, k, y, B, D, H, W, C, F, dil, relu, device,
                  s);
  };
  if (p.walk) {
    switch (p.n) {
      case 8: return go(ztap_conv_bf16_walk_kernel<8>);
      case 16: return go(ztap_conv_bf16_walk_kernel<16>);
      case 24: return go(ztap_conv_bf16_walk_kernel<24>);
      default: return go(ztap_conv_bf16_walk_kernel<32>);
    }
  }
  switch (p.n) {
    case 8: return go(ztap_conv_bf16_kernel<8>);
    case 16: return go(ztap_conv_bf16_kernel<16>);
    case 32: return go(ztap_conv_bf16_kernel<32>);
    case 48: return go(ztap_conv_bf16_kernel<48>);
    case 64: return go(ztap_conv_bf16_kernel<64>);
    case 96: return go(ztap_conv_bf16_kernel<96>);
    default: return go(ztap_conv_bf16_kernel<128>);
  }
}

}  // namespace zb

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

// bfloat16 (see above). x bf16 (B, D, H, W, C), k the bf16 weights packed
// as ztap_dilated_conv_bf16_plan says, y bf16 (B, D, H, W, F); contiguous,
// 16-byte aligned. Takes C % 8 == 0, any F >= 1, and 1 <= dil <= 8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ztap_dilated_conv_bf16(const void* x, const void* k, void* y,
                                      int B, int D, int H, int W, int C,
                                      int F, int dil, int relu, int device,
                                      void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 8 || C % 8 != 0 || F < 1 || dil < 1 || dil > kMaxDil)
    return (int)cudaErrorInvalidValue;
  return zb::dispatch(x, k, y, B, D, H, W, C, F, dil, relu, device,
                      static_cast<cudaStream_t>(stream));
}

// How ztap_dilated_conv_bf16 will run C, F, dil: out[0] = 1 for the slice
// walk, whose weights are (C32, 2, 2, 9, 3 FN, 8) with out[1] = FN (F
// rounded up to 8); 0 for one output slice a tile, whose weights are
// (groups, 3, 3, C32, 2, 2, 3, N, 8) with out[1] = N. C32: C in chunks of
// 32 channels; (2, 2): the chunk's k16 steps, each two planes of 8
// channels; 9 or 3: the (ky, kx) or kx taps of a stage; zeros past C and
// F. Returns 0, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int ztap_dilated_conv_bf16_plan(int C, int F, int dil, int* out) {
  if (C < 8 || C % 8 != 0 || F < 1 || dil < 1 || dil > kMaxDil)
    return (int)cudaErrorInvalidValue;
  const zb::Plan p = zb::plan_for(C, F, dil);
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  out[0] = p.walk;
  out[1] = p.n;
  return 0;
}
