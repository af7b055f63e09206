// Fused row statistics of the contrastive similarity matrix, forward and
// backward, in float32 — the debiased contrastive loss of refinement
// training (default step), the supervised contrastive loss (--pn step) and
// the single-view supcon of supervised training (--task cr).
//
// Replaces the TPU kernels of cet_pick_tpu/ops/pallas_gram.py:
//   ROW   gram_row_stats       (:153; Pallas bodies _fwd_kernel :92,
//                               _bwd_kernel :109)
//   LOGIT gram_logit_stats     (:290; _logit_fwd_kernel :244,
//                               _logit_bwd_kernel :260)
//   V2    gram_supcon_v2_stats (:422; _v2_fwd_kernel :366,
//                               _v2_bwd_kernel :387)
// Same functions, with a leading batch axis: feats (B, M, C), masks (B, M).
// ROW and LOGIT take L2-normalized features; per sample, with
// l_ij = (f_i.f_j - 1)/T off the diagonal and l_ii = 0, e_ij = exp(l_ij):
//   ROW   pos_sum_i = sum_j e_ij p_j, other_sum_i = sum_j e_ij o_j,
//         total_sum_i = sum_j e_ij            (the diagonal adds 1 to each,
//                                              under its mask)
//   LOGIT logit_pos_sum_i = sum_j l_ij p_j, total_sum_i = sum_j e_ij
// V2 takes raw features; s_ij = f_i.f_j/T off the diagonal, s_ii = 0 (the
// diagonal enters the max as 0), e_ij = exp(s_ij - mx_i):
//   V2    mx_i = max_j s_ij (no gradient), pos_sims_i = sum_j s_ij p_j,
//         neg_sims_i = sum_j s_ij n_j, tot_i = sum_j e_ij
// Backward, dF = W.F + W^T.F with w_ii = 0 and
//   ROW   w_ij = e_ij (g_pos_i p_j + g_other_i o_j + g_tot_i) / T
//   LOGIT w_ij = (g_lsum_i p_j + g_tot_i e_ij) / T
//   V2    w_ij = (g_ps_i p_j + g_ns_i n_j + g_tot_i e_ij) / T
// Rows and columns past M are masked by bounds, never padded: a column
// past M never enters a max or a sum.
//
// What bounds it on this card. At the training shape, M = 24,576 rows and
// C = 32 per sample, one gram product is 2 M^2 C = 3.87e10 FLOP against
// 3.1 MB of features: operations bind, by four orders of magnitude. The
// forward does one product and M^2 = 6.0e8 expf; the backward, as the TPU
// kernel counts it, three products (sims recompute, W.F, W^T.F). Against
// the H100 SXM's 67 TFLOP/s of dense FP32 that is ~0.58 ms forward and
// ~1.73 ms backward per sample.
//
// What the design does about it. The TPU kernel kept all features and an
// (M, C) column-gradient accumulator resident in VMEM across a sequential
// grid, and split f32 into bf16 hi/lo passes for its MXU. Nothing carries
// between blocks here, and the CUDA cores do f32 FMA natively:
//   * one block per (sample, 64-row tile), 256 threads as 16 x 16; the
//     block's own 64 x C tile and each 64 x C column tile sit transposed in
//     shared memory, and every thread computes a 4 x 4 micro-tile of sims
//     with f32 FMA over C (float4 loads, one broadcast);
//   * the epilogue (diagonal and bounds masks, expf — not __expf: the
//     exponent spans [-28.6, 0] at T = 0.07 — and the masked sums) runs on
//     the micro-tile in registers, so no sims element reaches device memory;
//   * backward, row pass: the same loop recomputes e, writes the w tile to
//     shared memory, and accumulates grow_a = sum_b w_ab f_b (a 64 x 64 by
//     64 x C product from shared memory) in registers;
//   * backward, column pass: the same kernel with the roles swapped — one
//     block per 64-column tile a, looping over row tiles b, with w_ba formed
//     from the rows' cotangents and the columns' masks — adds
//     gcol_a = sum_b w_ba f_b to the row pass's result. Its sims are the
//     row pass's (the product runs over c in one order either way);
//   * no atomics and no split-K: every output has one owner and one sum
//     order, so results are the same from run to run.
// The two-pass backward recomputes the sims twice (four products where the
// TPU kernel counts three), so it can reach at most 75% of that bound.
// Tensor cores (wgmma with 3xTF32), TMA staging and symmetry are later work.
//
// V2 at its main-path shape (the cr step: B = 2 crops, M = 6 x 32 x 32 =
// 6144, C = 32): one product is 2 M^2 C = 2.42e9 FLOP per sample, 4.8e9
// for the batch, 0.072 ms at 67 TFLOP/s. Its forward takes two sweeps over
// the column tiles: the first forms the row max (and the two masked sums,
// which need no max), the second sum_j exp(s_ij - mx_i) against the final
// max, as JAX does — two products where an online max with rescaling
// would take one (later speed work). Its backward is the two passes above,
// with the row max of the row index in the per-index data. The grid is
// 96 x 2 = 192 blocks on 132 SMs, under two waves.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;           // owned and looped tile extent
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 micro-tiles
constexpr int kLd = kTile + 4;      // row stride of transposed / w tiles
constexpr int kData = 6;            // per-index rows of the backward's data

enum { ROW = 0, LOGIT = 1, V2 = 2 };
enum { PASS_ROWS = 0, PASS_COLS = 1 };

struct Args {
  const float* f;      // (B, M, C)
  const float* pos;    // (B, M)
  const float* other;  // (B, M), ROW: other; V2: neg
  const float* g0;     // ROW: g_pos;   LOGIT: g_lsum; V2: g_ps   (B, M)
  const float* g1;     // ROW: g_other; LOGIT: g_tot;  V2: g_ns   (B, M)
  const float* g2;     // ROW: g_tot;                  V2: g_tot  (B, M)
  const float* mx;     // V2 backward: the forward's row max      (B, M)
  float* out0;         // forward: the row stats; backward: the gradient
  float* out1;
  float* out2;
  float* out3;
  int M, C;
  float inv_t;
};

// Stage rows [r0, r0 + 64) of one sample's (M, C) features: transposed into
// t[c * kLd + r], and row-major into rm[r * CP + c] when rm is given. Rows
// past M and channels past C are zeros.
template <int CP>
__device__ __forceinline__ void load_tile(const float* f, int M, int C, int r0,
                                          float* t, float* rm) {
  for (int idx = threadIdx.x; idx < kTile * CP; idx += kThreads) {
    const int r = idx / CP, c = idx % CP;
    const int gr = r0 + r;
    const float v = (gr < M && c < C) ? f[(size_t)gr * C + c] : 0.f;
    t[c * kLd + r] = v;
    if (rm != nullptr) rm[r * CP + c] = v;
  }
}

// s[ii][jj] = sum_c a[ty*4 + ii][c] * b[tx*4 + jj][c], over the transposed
// tiles, in the order c = 0, 1, ..., CP - 1.
template <int CP>
__device__ __forceinline__ void sims_tile(const float* aT, const float* bT,
                                          int tx, int ty, float s[4][4]) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
  for (int c = 0; c < CP; ++c) {
    const float4 av = *reinterpret_cast<const float4*>(aT + c * kLd + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(bT + c * kLd + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(ar[ii], br[jj], s[ii][jj]);
  }
}

template <int V, int CP>
__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);  // CP x kLd, owned rows
  float* bT = aT + CP * kLd;                    // CP x kLd, column tile
  float* bp = bT + CP * kLd;                    // column masks
  float* bo = bp + kTile;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int M = a.M;
  const int a0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * M;
  const float* f = a.f + base * a.C;
  const float inv_t = a.inv_t;

  load_tile<CP>(f, M, a.C, a0, aT, nullptr);
  float acc[4][3];
  float mx[4];  // V2: the row max, -inf until a column is seen
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    mx[ii] = __int_as_float(0xff800000);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[ii][k] = 0.f;
  }

  // sweep 1: ROW / LOGIT sums; V2 row max and masked sims sums
  for (int b0 = 0; b0 < M; b0 += kTile) {
    __syncthreads();  // the previous column tile is consumed
    load_tile<CP>(f, M, a.C, b0, bT, nullptr);
    if (threadIdx.x < kTile) {
      const int j = b0 + threadIdx.x;
      bp[threadIdx.x] = j < M ? a.pos[base + j] : 0.f;
      if (V != LOGIT) bo[threadIdx.x] = j < M ? a.other[base + j] : 0.f;
    }
    __syncthreads();
    float s[4][4];
    sims_tile<CP>(aT, bT, tx, ty, s);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int jl = tx * 4 + jj;
      const int j = b0 + jl;
      if (j >= M) continue;
      const float p = bp[jl];
      const float o = V != LOGIT ? bo[jl] : 0.f;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = a0 + ty * 4 + ii;
        if (V == V2) {
          const float sv = i == j ? 0.f : s[ii][jj] * inv_t;
          mx[ii] = fmaxf(mx[ii], sv);
          acc[ii][0] = fmaf(sv, p, acc[ii][0]);
          acc[ii][1] = fmaf(sv, o, acc[ii][1]);
          continue;
        }
        const float l = i == j ? 0.f : s[ii][jj] * inv_t - inv_t;
        const float e = expf(l);
        if (V == ROW) {
          acc[ii][0] = fmaf(e, p, acc[ii][0]);
          acc[ii][1] = fmaf(e, o, acc[ii][1]);
          acc[ii][2] += e;
        } else {
          acc[ii][0] = fmaf(l, p, acc[ii][0]);
          acc[ii][1] += e;
        }
      }
    }
  }

  if (V == V2) {
    // the row max over the 16 lanes of the row group (a max has no order),
    // then sweep 2: sum_j exp(s_ij - mx_i) against the final max
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], off));
    for (int b0 = 0; b0 < M; b0 += kTile) {
      __syncthreads();
      load_tile<CP>(f, M, a.C, b0, bT, nullptr);
      __syncthreads();
      float s[4][4];
      sims_tile<CP>(aT, bT, tx, ty, s);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = b0 + tx * 4 + jj;
        if (j >= M) continue;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = a0 + ty * 4 + ii;
          const float sv = i == j ? 0.f : s[ii][jj] * inv_t;
          acc[ii][2] += expf(sv - mx[ii]);
        }
      }
    }
  }

  // the 16 threads of a row group are one half warp: a fixed-order
  // butterfly over lanes
  constexpr int kStats = V == LOGIT ? 2 : 3;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int k = 0; k < kStats; ++k)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        acc[ii][k] += __shfl_xor_sync(0xffffffffu, acc[ii][k], off);
  if (tx == 0) {
    // V2 writes (mx, pos_sims, neg_sims, tot) to out0..out3
    float* outs[3] = {V == V2 ? a.out1 : a.out0, V == V2 ? a.out2 : a.out1,
                      V == V2 ? a.out3 : a.out2};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = a0 + ty * 4 + ii;
      if (i >= M) continue;
      if (V == V2) a.out0[base + i] = mx[ii];
#pragma unroll
      for (int k = 0; k < kStats; ++k) outs[k][base + i] = acc[ii][k];
    }
  }
}

// One backward pass. The block owns the 64 indices a of its tile and loops
// over tiles of indices b; for each pair the weight is w_ij with (i, j) =
// (a, b) in the row pass and (b, a) in the column pass, and the block
// accumulates G_a = sum_b w * f_b. The row pass writes G to the gradient,
// the column pass adds it (they run in that order on one stream).
template <int V, int PASS, int CP>
__global__ void __launch_bounds__(kThreads)
gram_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);  // CP x kLd, owned tile
  float* bT = aT + CP * kLd;                    // CP x kLd, looped tile
  float* bw = bT + CP * kLd;                    // kTile x kLd, w[a][b]
  float* brm = bw + kTile * kLd;                // kTile x CP, looped rows
  float* bd = brm + kTile * CP;                 // kData x kTile, looped data

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int M = a.M;
  const int a0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * M;
  const float* f = a.f + base * a.C;
  const float inv_t = a.inv_t;

  // per-index data: cotangents g0..g2 and, for V2, the row max (its row
  // role), masks p, o (its column role); zeros past M
  auto data = [&](int k, float d[kData]) {
    const bool v = k < M;
    d[0] = v ? a.g0[base + k] : 0.f;
    d[1] = v ? a.g1[base + k] : 0.f;
    d[2] = (V != LOGIT && v) ? a.g2[base + k] : 0.f;
    d[3] = v ? a.pos[base + k] : 0.f;
    d[4] = (V != LOGIT && v) ? a.other[base + k] : 0.f;
    d[5] = (V == V2 && v) ? a.mx[base + k] : 0.f;
  };
  float own[4][kData];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) data(a0 + ty * 4 + ii, own[ii]);

  load_tile<CP>(f, M, a.C, a0, aT, nullptr);
  constexpr int kQ = CP / 16;  // channels per thread: c = tx + 16 q
  float acc[4][kQ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[ii][q] = 0.f;

  for (int b0 = 0; b0 < M; b0 += kTile) {
    __syncthreads();  // the previous tile's w and rows are consumed
    load_tile<CP>(f, M, a.C, b0, bT, brm);
    if (threadIdx.x < kTile) {
      float d[kData];
      data(b0 + threadIdx.x, d);
#pragma unroll
      for (int k = 0; k < kData; ++k) bd[k * kTile + threadIdx.x] = d[k];
    }
    __syncthreads();
    float s[4][4];
    sims_tile<CP>(aT, bT, tx, ty, s);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int ia = a0 + ty * 4 + ii;
      float w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jl = tx * 4 + jj;
        const int ib = b0 + jl;
        w[jj] = 0.f;
        if (ib < M && ia != ib) {
          // cotangents and row max of the row i, masks of the column j
          float r0, r1, r2, rmx, cp, co;
          if (PASS == PASS_ROWS) {
            r0 = own[ii][0], r1 = own[ii][1], r2 = own[ii][2];
            rmx = own[ii][5];
            cp = bd[3 * kTile + jl], co = bd[4 * kTile + jl];
          } else {
            r0 = bd[jl], r1 = bd[kTile + jl], r2 = bd[2 * kTile + jl];
            rmx = bd[5 * kTile + jl];
            cp = own[ii][3], co = own[ii][4];
          }
          if (V == V2) {
            const float e = expf(s[ii][jj] * inv_t - rmx);
            w[jj] = (r0 * cp + r1 * co + r2 * e) * inv_t;
          } else {
            const float e = expf(s[ii][jj] * inv_t - inv_t);
            if (V == ROW)
              w[jj] = e * (r0 * cp + r1 * co + r2) * inv_t;
            else
              w[jj] = (r0 * cp + r1 * e) * inv_t;
          }
        }
      }
      *reinterpret_cast<float4*>(bw + (ty * 4 + ii) * kLd + tx * 4) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    // G[a][c] += sum_b w[a][b] f_b[c], b = 0, 1, ..., 63 in order
#pragma unroll 2
    for (int b = 0; b < kTile; b += 4) {
      float4 wv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        wv[ii] = *reinterpret_cast<const float4*>(bw + (ty * 4 + ii) * kLd + b);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float fv = brm[(b + bb) * CP + tx + 16 * q];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float wab = bb == 0 ? wv[ii].x : bb == 1 ? wv[ii].y
                            : bb == 2 ? wv[ii].z : wv[ii].w;
            acc[ii][q] = fmaf(wab, fv, acc[ii][q]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int ia = a0 + ty * 4 + ii;
    if (ia >= M) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = tx + 16 * q;
      if (c >= a.C) continue;
      float* g = a.out0 + (base + ia) * a.C + c;
      if (PASS == PASS_ROWS)
        *g = acc[ii][q];
      else
        *g += acc[ii][q];
    }
  }
}

template <typename K>
int launch(K kernel, size_t smem, int B, int M, const Args& args,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((M + kTile - 1) / kTile), (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int V, int CP>
int fwd(int B, const Args& args, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)CP * kLd + 2 * kTile) * sizeof(float);
  return launch(gram_fwd_kernel<V, CP>, smem, B, args.M, args, stream);
}

template <int V, int CP>
int bwd(int pass, int B, const Args& args, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)CP * kLd + (size_t)kTile * kLd +
                       (size_t)kTile * CP + kData * kTile) * sizeof(float);
  if (pass == PASS_ROWS)
    return launch(gram_bwd_kernel<V, PASS_ROWS, CP>, smem, B, args.M, args,
                  stream);
  return launch(gram_bwd_kernel<V, PASS_COLS, CP>, smem, B, args.M, args,
                stream);
}

// C rounded up to the instantiated widths (zero channels add nothing).
template <typename F>
int by_width(int C, F&& f) {
  if (C <= 32) return f(std::integral_constant<int, 32>());
  if (C <= 64) return f(std::integral_constant<int, 64>());
  if (C <= 96) return f(std::integral_constant<int, 96>());
  return f(std::integral_constant<int, 128>());
}

int check(int variant, int B, int M, int C, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (variant < ROW || variant > V2 || B < 1 || B > 65535 || M < 1 ||
      C < 1 || C > 128 || C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename F>
int by_variant(int variant, F&& f) {
  if (variant == ROW) return f(std::integral_constant<int, ROW>());
  if (variant == LOGIT) return f(std::integral_constant<int, LOGIT>());
  return f(std::integral_constant<int, V2>());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous float32 tensors; the stream is PyTorch's current stream. The
// functions only launch: they allocate nothing and do not synchronize.
// They return cudaGetLastError() after the launch (0 on success).
//
// variant 0 (ROW): outputs pos_sum, other_sum, total_sum (B, M).
// variant 1 (LOGIT): outputs logit_pos_sum, total_sum; other is unused.
// variant 2 (V2): outputs mx, pos_sims, neg_sims, tot; other is neg.
extern "C" int gram_stats_fwd_f32(int variant, const void* f, const void* pos,
                                  const void* other, void* out0, void* out1,
                                  void* out2, void* out3, int B, int M, int C,
                                  float inv_t, int device, void* stream) {
  const int err = check(variant, B, M, C, device);
  if (err) return err;
  Args a{static_cast<const float*>(f), static_cast<const float*>(pos),
         static_cast<const float*>(other), nullptr, nullptr, nullptr, nullptr,
         static_cast<float*>(out0), static_cast<float*>(out1),
         static_cast<float*>(out2), static_cast<float*>(out3), M, C, inv_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, [&](auto v) {
    return by_width(C, [&](auto cp) {
      return fwd<decltype(v)::value, decltype(cp)::value>(B, a, s);
    });
  });
}

// One backward pass: pass 0 writes grad = W.F (rows), pass 1 adds W^T.F
// (columns); launch pass 0 first. Cotangents g0, g1, g2 and mx as in Args.
extern "C" int gram_stats_bwd_f32(int variant, int pass, const void* f,
                                  const void* pos, const void* other,
                                  const void* g0, const void* g1,
                                  const void* g2, const void* mx, void* grad,
                                  int B, int M, int C, float inv_t, int device,
                                  void* stream) {
  const int err = check(variant, B, M, C, device);
  if (err) return err;
  if (pass != PASS_ROWS && pass != PASS_COLS)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(f), static_cast<const float*>(pos),
         static_cast<const float*>(other), static_cast<const float*>(g0),
         static_cast<const float*>(g1), static_cast<const float*>(g2),
         static_cast<const float*>(mx), static_cast<float*>(grad), nullptr,
         nullptr, nullptr, M, C, inv_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, [&](auto v) {
    return by_width(C, [&](auto cp) {
      return bwd<decltype(v)::value, decltype(cp)::value>(pass, B, a, s);
    });
  });
}
