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
// pixel against x read once and y written once. At the unet_N main-path
// shape — 70x256x256 per z window, C = F = 32 — that is 2.54e11 FLOP per
// window against ~1.17 GB (217 FLOP/byte); at the unetw_N shape —
// (4, 70, 128, 128), C = F = 128 — 4.06e12 FLOP per launch against 2.35 GB
// in and 2.35 GB out (1.4 ms at 3.35 TB/s). The H100 SXM does 67 TFLOP/s
// of dense FP32 FMA outside the tensor cores, so both are bound by FP32
// operations: ~3.8 ms per unet_N window, ~60.6 ms per unetw_N launch.
//
// What the design does about it. The TPU kernel carried a 3-deep VMEM ring
// of per-z im2col products over a sequential grid; nothing carries between
// blocks here, so each block recomputes nothing and shares nothing:
//   * one block per (b, z, 16x32 tile of output pixels, group of up to 32
//     outputs), 256 threads; each thread owns 2 output pixels (rows 8
//     apart) and keeps the group's outputs of both in f32 registers (64
//     accumulators at most, whatever F is), so the intermediate u of the
//     z-tap form is never written to device memory;
//   * the weights are staged in shared memory one (kz, 32-channel chunk)
//     slab at a time — 9 x 32 x 32 floats = 36,864 B whatever C and F are,
//     where a whole kz slab would need 576 KB at C = F = 128 — and read as
//     warp-uniform float4 broadcasts, each reused for both pixels: 1 shared
//     load feeds 8 FMAs;
//   * x is read straight from global memory as float4 over channels; the
//     L1 cache serves the 9 xy taps' overlap between neighbouring threads,
//     and L2 the re-reads of x by the other output groups (F / 32 of them);
//   * every output's sum runs in one fixed order, (kz, channel chunk, ky,
//     kx, c), with no split-K and no atomics: the result does not depend on
//     where a z window starts, which keeps tiled == full exact for the head.
// The FMA pipes are the limit; tensor cores (wgmma, 3xTF32), TMA staging of
// x and a persistent schedule are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                      // output pixels along W (one per lane)
constexpr int kRowsPerPass = 8;                 // warps per block, one output row each
constexpr int kPix = 2;                         // output rows per thread, kRowsPerPass apart
constexpr int kTileH = kRowsPerPass * kPix;     // 16
constexpr int kThreads = kTileW * kRowsPerPass; // 256
constexpr int kChunk = 32;                      // channels per staged weight slab
constexpr int kGroup = 32;                      // outputs per block (F > 32)

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// FG outputs per block: f0 = blockIdx.y * FG of the F outputs.
template <int FG>
__global__ void __launch_bounds__(kThreads, 2)
ztap_conv_kernel(const float* __restrict__ x, const float* __restrict__ k,
                 float* __restrict__ y, int D, int H, int W, int C, int F,
                 int dil, int tiles_w, int tiles_h, int relu) {
  extern __shared__ float4 w_smem[];  // one slab: (ky, kx, c of the chunk, f)
  const float* w_s = reinterpret_cast<const float*>(w_smem);

  const long long tiles = (long long)tiles_w * tiles_h;
  const long long bid = blockIdx.x;
  const int tile = (int)(bid % tiles);
  const long long bz = bid / tiles;  // b * D + z
  const int z = (int)(bz % D);
  const long long b = bz / D;
  const int f0 = blockIdx.y * FG;
  const int ox = (tile % tiles_w) * kTileW + (int)(threadIdx.x % kTileW);
  const int oy0 = (tile / tiles_w) * kTileH + (int)(threadIdx.x / kTileW);

  float acc[kPix][FG];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int f = 0; f < FG; ++f) acc[p][f] = 0.f;

  const size_t row_stride = (size_t)W * C;

  for (int kz = 0; kz < 3; ++kz) {
    const int zi = z + kz - 1;
    if (zi < 0 || zi >= D) continue;  // uniform over the block
    const float* xz = x + (size_t)(b * D + zi) * H * row_stride;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int cc = min(kChunk, C - c0);  // a multiple of 4
      __syncthreads();                     // the previous slab is consumed
      // w_s[(t * cc + cl) * FG + fl] = k[kz, t, c0 + cl, f0 + fl], t = ky*3+kx
      const int n4 = 9 * cc * (FG / 4);
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const int f4 = i % (FG / 4);
        const int row = i / (FG / 4);  // t * cc + cl
        const int t = row / cc, cl = row % cc;
        w_smem[i] = *reinterpret_cast<const float4*>(
            k + (((size_t)kz * 9 + t) * C + c0 + cl) * F + f0 + 4 * f4);
      }
      __syncthreads();

      for (int ky = 0; ky < 3; ++ky) {
        bool vy[kPix];
        const float* rowp[kPix];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const int iy = oy0 + p * kRowsPerPass + (ky - 1) * dil;
          vy[p] = iy >= 0 && iy < H;
          rowp[p] = xz + (size_t)(vy[p] ? iy : 0) * row_stride;
        }
        for (int kx = 0; kx < 3; ++kx) {
          const int ix = ox + (kx - 1) * dil;
          const bool vx = ix >= 0 && ix < W;
          bool v[kPix];
          const float4* px[kPix];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            v[p] = vx && vy[p];
            px[p] = reinterpret_cast<const float4*>(
                rowp[p] + (size_t)(v[p] ? ix : 0) * C + c0);
          }
          const float* wt = w_s + (ky * 3 + kx) * cc * FG;
          for (int c4 = 0; c4 < cc / 4; ++c4) {
            float4 a[kPix];
#pragma unroll
            for (int p = 0; p < kPix; ++p)
              a[p] = v[p] ? __ldg(px[p] + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
            const float* wc = wt + c4 * 4 * FG;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4* wr = reinterpret_cast<const float4*>(wc + j * FG);
#pragma unroll
              for (int f4 = 0; f4 < FG / 4; ++f4) {
                const float4 w = wr[f4];
#pragma unroll
                for (int p = 0; p < kPix; ++p) {
                  const float s = lane_of(a[p], j);
                  acc[p][4 * f4 + 0] = fmaf(s, w.x, acc[p][4 * f4 + 0]);
                  acc[p][4 * f4 + 1] = fmaf(s, w.y, acc[p][4 * f4 + 1]);
                  acc[p][4 * f4 + 2] = fmaf(s, w.z, acc[p][4 * f4 + 2]);
                  acc[p][4 * f4 + 3] = fmaf(s, w.w, acc[p][4 * f4 + 3]);
                }
              }
            }
          }
        }
      }
    }
  }

  if (ox >= W) return;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int oy = oy0 + p * kRowsPerPass;
    if (oy >= H) continue;
    float4* dst = reinterpret_cast<float4*>(
        y + ((size_t)bz * H * W + (size_t)oy * W + ox) * F + f0);
#pragma unroll
    for (int f4 = 0; f4 < FG / 4; ++f4) {
      float4 o = make_float4(acc[p][4 * f4 + 0], acc[p][4 * f4 + 1],
                             acc[p][4 * f4 + 2], acc[p][4 * f4 + 3]);
      if (relu) {
        o.x = fmaxf(o.x, 0.f);
        o.y = fmaxf(o.y, 0.f);
        o.z = fmaxf(o.z, 0.f);
        o.w = fmaxf(o.w, 0.f);
      }
      dst[f4] = o;
    }
  }
}

template <int FG>
int launch(const float* x, const float* k, float* y, int B, int D, int H,
           int W, int C, int F, int dil, int relu, cudaStream_t stream) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)tiles_w * tiles_h * B * D;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)9 * kChunk * FG * sizeof(float);  // <= 36,864 B
  const dim3 grid((unsigned)blocks, (unsigned)(F / FG));
  ztap_conv_kernel<FG><<<grid, kThreads, smem, stream>>>(
      x, k, y, D, H, W, C, F, dil, tiles_w, tiles_h, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous float32 tensors; the stream is PyTorch's current stream. The
// function only launches: it allocates nothing and does not synchronize.
// Takes C % 4 == 0 and F = 16 or a multiple of 32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ztap_dilated_conv_f32(const void* x, const void* k, void* y,
                                     int B, int D, int H, int W, int C, int F,
                                     int dil, int relu, int device,
                                     void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 4 || C % 4 != 0 || F < 16 || F > 65535 * kGroup)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* kp = static_cast<const float*>(k);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F == 16) return launch<16>(xp, kp, yp, B, D, H, W, C, F, dil, relu, s);
  if (F % kGroup == 0)
    return launch<kGroup>(xp, kp, yp, B, D, H, W, C, F, dil, relu, s);
  return (int)cudaErrorInvalidValue;
}
