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
// forward does one product and M^2 = 6.0e8 expf. The backward needs two
// products: s_ij = s_ji, so dF_a = sum_b (w_ab + w_ba) f_b takes one sims
// product and one (W + W^T).F product (the TPU kernel counts three, sims,
// W.F and W^T.F), and M^2 expf (2 M^2 for V2). Against the H100 SXM's
// 67 TFLOP/s of dense FP32 that is ~0.58 ms forward, ~1.15 ms backward per
// sample; in 3xTF32 on the tensor cores (495 / 3 TFLOP/s) 0.23 / 0.47 ms,
// where the exp epilogue (~25 instructions a pair) is a floor of the same
// order. This design is bound by instruction issue more than by that
// epilogue (a variant with the epilogue cut to one multiply-add kept most
// of the time): fragment loads and tf32 splits (each F_b element is split
// by four warps in each product), the mma.sync stream and three block
// barriers a tile.
//
// The forward. The TPU kernel kept all features resident in VMEM across a
// sequential grid and split f32 into bf16 hi/lo passes for its MXU; here
// one block per (sample, 64-row tile), 256 threads as 16 x 16, the block's
// own tile and each 64 x C column tile transposed in shared memory, every
// thread a 4 x 4 micro-tile of sims in f32 FMA over C; the epilogue
// (diagonal and bounds masks, expf — not __expf: the exponent spans
// [-28.6, 0] at T = 0.07 — and the masked sums) on the micro-tile in
// registers, so no sims element reaches device memory. V2 sweeps the
// column tiles twice: the row max (and the two masked sums, which need no
// max), then sum_j exp(s_ij - mx_i) against the final max, as JAX does.
//
// The backward, one fused pass in 3xTF32 on the tensor cores
// (tf32x3.cuh, mma.sync.m16n8k8; fragments split in registers). The TPU
// kernel kept an (M, C) column-gradient accumulator in VMEM; here:
//   * one block owns row tile a (64 rows) and walks the column tiles b of
//     its slice in order; per pair it takes S = F_a F_b^T (64 x 64, K = C),
//     forms w_ab (cotangents of a, masks of b) + w_ba (cotangents of b,
//     masks of a) in the epilogue — one expf a pair for ROW and LOGIT,
//     where e_ab = e_ba; two for V2, whose e differs by the row max — into
//     shared memory, and accumulates G_a += (W + W^T)_ab F_b (K = 64), in
//     registers: two products and one launch;
//   * F_a, F_b and the per-index data (g0..g2, p, o, mx) are staged with
//     cp.async, F_b and the data in a two-stage ring; tiles are row-major
//     with an XOR swizzle of the column (bits 3-4 by the row, `sw`) so that
//     both fragment patterns — F_b as the B operand of S (n = row, a float2
//     a lane) and of W.F (k = row) — hit 32 distinct banks. At C <= 32 the
//     own rows' split A fragments stay in registers for the whole block;
//   * S (K = C, a few k steps) accumulates in the mma's own C; G, the long
//     sum over the slice, takes each k step's 3 products in a fresh
//     accumulator that is then added to it (tf32x3.cuh: the tensor core
//     truncates what it adds to a large accumulator; once a tile, 24
//     products, broke the logit gradient's 3e-5 bar at (2, 1000, 32));
//   * filling the card: the b tiles are cut into `slices` fixed ranges
//     (grid (tiles, slices, B)), chosen by the wrapper from M and B alone
//     so that the grid has ~1024 blocks (one block a row tile is 96
//     blocks on 132 SMs at M = 6144). Each slice writes its partial
//     gradient to a scratch tensor the
//     wrapper allocates; a second small kernel sums the partials in slice
//     order. With one slice the pass writes the gradient itself;
//   * no atomics: every sum has one owner and one order, so results are
//     bit-identical from run to run.
// mma.sync rather than wgmma, as in ztap_conv.cu: fragments from plain
// shared-memory loads, no descriptor layouts; wgmma is later work.
// The forward keeps its f32 FMA design for now (next on the queue).

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kTile = 64;           // owned and looped tile extent
constexpr int kThreads = 256;       // forward: 16 x 16 threads, 4 x 4 micro-tiles;
                                    // backward: 8 warps as 4 (rows) x 2
constexpr int kLd = kTile + 4;      // row stride of the forward's transposed tiles
constexpr int kData = 6;            // per-index rows of the backward's data

enum { ROW = 0, LOGIT = 1, V2 = 2 };

struct Args {
  const float* f;      // (B, M, C)
  const float* pos;    // (B, M)
  const float* other;  // (B, M), ROW: other; V2: neg
  const float* g0;     // ROW: g_pos;   LOGIT: g_lsum; V2: g_ps   (B, M)
  const float* g1;     // ROW: g_other; LOGIT: g_tot;  V2: g_ns   (B, M)
  const float* g2;     // ROW: g_tot;                  V2: g_tot  (B, M)
  const float* mx;     // V2 backward: the forward's row max      (B, M)
  float* out0;         // forward: the row stats; backward: the gradient
  float* out1;         // (slices == 1) or the (slices, B, M, C) partials
  float* out2;
  float* out3;
  int M, C;
  float inv_t;
  int per;             // backward: column tiles per slice
};

// Stage rows [r0, r0 + 64) of one sample's (M, C) features transposed into
// t[c * kLd + r]. Rows past M and channels past C are zeros.
template <int CP>
__device__ __forceinline__ void load_tile(const float* f, int M, int C, int r0,
                                          float* t) {
  for (int idx = threadIdx.x; idx < kTile * CP; idx += kThreads) {
    const int r = idx / CP, c = idx % CP;
    const int gr = r0 + r;
    t[c * kLd + r] = (gr < M && c < C) ? f[(size_t)gr * C + c] : 0.f;
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

  load_tile<CP>(f, M, a.C, a0, aT);
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
    load_tile<CP>(f, M, a.C, b0, bT);
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
      load_tile<CP>(f, M, a.C, b0, bT);
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

// Float offset of column k of row r in a row-major tile of L floats a row
// (L a multiple of 32): bits 3-4 of the column are XORed with
// (r & 3) ^ ((r >> 2) & 1) of the row, which differs for any 4
// consecutive rows from a multiple of 4 and for rows {0, 2, 4, 6} and
// {1, 3, 5, 7} of an 8-row group. So a fragment of float2 pairs at
// columns 2t, 2t + 1 of 8 rows (A of both products, B of F_a F_b^T), and
// single floats at rows 2t (or 2t + 1) and 8 consecutive columns (B of
// W.F_b), each hit 32 distinct banks; 16-byte groups of 4 columns stay
// whole for cp.async.
template <int L>
__device__ __forceinline__ int sw(int r, int k) {
  return r * L + (k ^ (((r & 3) ^ ((r >> 2) & 1)) << 3));
}

// A fragment of rows r and r + 8 at k step k0 of a swizzled tile: k = t
// and t + 4 are columns k0 + 2t and k0 + 2t + 1, one float2 a row.
template <int L>
__device__ __forceinline__ FragA a_frag(const float* tile, int r, int k0,
                                        int t) {
  const float2 x0 =
      *reinterpret_cast<const float2*>(tile + sw<L>(r, k0 + 2 * t));
  const float2 x1 =
      *reinterpret_cast<const float2*>(tile + sw<L>(r + 8, k0 + 2 * t));
  return tf32x3::split_a(x0.x, x1.x, x0.y, x1.y);
}

// The fused backward. The block owns the 64 indices a of row tile
// blockIdx.x and walks column tiles b of slice blockIdx.y in order; per
// pair it forms (W + W^T)_ab and accumulates G_a = sum_b (W + W^T)_ab F_b.
// It writes G_a to out0 + (slice * B + sample) * M * C: the gradient
// itself with one slice, else that slice's partial.
// Two blocks an SM (128 registers a thread) where that does not spill, at
// C <= 64; wider tiles spill under that cap, so they keep one block an SM
// and every register they need.
template <int V, int CP>
__global__ void __launch_bounds__(kThreads, CP <= 64 ? 2 : 1)
gram_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* const fa = reinterpret_cast<float*>(smem4);  // kTile x CP, own rows
  float* const fb = fa + kTile * CP;            // 2 stages of kTile x CP
  float* const bd = fb + 2 * kTile * CP;        // 2 stages of kData x kTile
  float* const w = bd + 2 * kData * kTile;      // kTile x kTile

  const int M = a.M, C = a.C;
  const int a0 = blockIdx.x * kTile;
  const int tiles = (M + kTile - 1) / kTile;
  const int t_begin = blockIdx.y * a.per;
  const int t_end = min(tiles, t_begin + a.per);
  const size_t base = (size_t)blockIdx.z * M;
  const float* f = a.f + base * C;
  const float inv_t = a.inv_t;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp % 2;
  const int rl = 16 * (warp / 2) + g;  // the thread's rows: rl and rl + 8

  // per-index data, rows k = 0..5: cotangents g0, g1, g2 (row role), masks
  // p, o (column role), V2's row max (row role); zeros where unused
  auto data_src = [&](int k) -> const float* {
    return k == 0 ? a.g0 : k == 1 ? a.g1 : k == 2 ? a.g2 : k == 3 ? a.pos
         : k == 4 ? a.other : a.mx;
  };
  auto data_used = [](int k) {
    return k == 0 || k == 1 || k == 3 || (V != LOGIT && (k == 2 || k == 4)) ||
           (V == V2 && k == 5);
  };
  auto stage_rows = [&](int r0, float* dst) {  // features, zeros past M / C
    constexpr int kC4 = CP / 4;
    for (int i = threadIdx.x; i < kTile * kC4; i += kThreads) {
      const int r = i / kC4, c = 4 * (i % kC4);
      const bool v = r0 + r < M && c < C;
      tf32x3::cp_async16(dst + sw<CP>(r, c),
                         v ? f + (size_t)(r0 + r) * C + c : a.f, v);
    }
  };
  auto stage_data = [&](int j0, float* dst) {
    for (int i = threadIdx.x; i < kData * kTile; i += kThreads) {
      const int k = i / kTile, j = j0 + i % kTile;
      const bool v = j < M && data_used(k);
      tf32x3::cp_async4(dst + i, v ? data_src(k) + base + j : a.f, v);
    }
  };

  float own[2][kData];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = a0 + rl + 8 * h;
#pragma unroll
    for (int k = 0; k < kData; ++k)
      own[h][k] = (i < M && data_used(k)) ? data_src(k)[base + i] : 0.f;
  }

  constexpr int kNG = CP / 16;  // n8 tiles of G a warp: CP / 2 channels
  constexpr int kKSteps = CP / 8;
  // the own rows' A fragments of S stay in registers, split, when they fit
  constexpr bool kARegs = CP <= 32;
  FragA fa_frag[kARegs ? kKSteps : 1];
  float gacc[kNG][4];
#pragma unroll
  for (int n = 0; n < kNG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[n][e] = 0.f;

  stage_rows(a0, fa);
  if (t_begin < t_end) {
    stage_rows(t_begin * kTile, fb);
    stage_data(t_begin * kTile, bd);
  }
  tf32x3::cp_async_commit();
  for (int tb = t_begin; tb < t_end; ++tb) {
    const int slot = (tb - t_begin) & 1;
    if (tb + 1 < t_end) {
      stage_rows((tb + 1) * kTile, fb + (slot ^ 1) * kTile * CP);
      stage_data((tb + 1) * kTile, bd + (slot ^ 1) * kData * kTile);
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    __syncthreads();
    const float* fbs = fb + slot * kTile * CP;
    const float* bds = bd + slot * kData * kTile;
    if (kARegs && tb == t_begin) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        fa_frag[kk] = a_frag<CP>(fa, rl, 8 * kk, t);
    }

    // S = F_a F_b^T: the warp's 16 rows x 32 columns (4 n8 tiles), K = CP
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const FragA af = kARegs ? fa_frag[kk] : a_frag<CP>(fa, rl, 8 * kk, t);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 bv = *reinterpret_cast<const float2*>(
            fbs + sw<CP>(32 * wn + 8 * n + g, 8 * kk + 2 * t));
        tf32x3::mma3(s[n], af, tf32x3::split_b(bv.x, bv.y));
      }
    }

    // (W + W^T)_ab from the sims in registers; C fragment element e is
    // row rl + 8 (e / 2), column 32 wn + 8 n + 2 t + (e % 2)
    const int b0 = tb * kTile;
    // only the diagonal tile and the last one need the i == j and j >= M
    // masks
    const bool masked = b0 == a0 || b0 + kTile > M;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = a0 + rl + 8 * h;
        const float g0i = own[h][0], g1i = own[h][1], g2i = own[h][2];
        const float pi = own[h][3], oi = own[h][4];
        float wv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 32 * wn + 8 * n + 2 * t + e;
          const int j = b0 + jl;
          const float* d = bds + jl;  // d[k * kTile]: data of index j
          wv[e] = 0.f;
          if (!masked || (j < M && i != j)) {
            const float sv = s[n][2 * h + e] * inv_t;
            if (V == ROW) {
              const float ex = expf(sv - inv_t);
              wv[e] = ex * ((g0i * d[3 * kTile] + g1i * d[4 * kTile] + g2i) +
                            (d[0] * pi + d[kTile] * oi + d[2 * kTile])) *
                      inv_t;
            } else if (V == LOGIT) {
              const float ex = expf(sv - inv_t);
              wv[e] = ((g0i * d[3 * kTile] + g1i * ex) +
                       (d[0] * pi + d[kTile] * ex)) * inv_t;
            } else {
              const float ei = expf(sv - own[h][5]);
              const float ej = expf(sv - d[5 * kTile]);
              wv[e] = ((g0i * d[3 * kTile] + g1i * d[4 * kTile] + g2i * ei) +
                       (d[0] * pi + d[kTile] * oi + d[2 * kTile] * ej)) *
                      inv_t;
            }
          }
        }
        *reinterpret_cast<float2*>(
            w + sw<kTile>(rl + 8 * h, 32 * wn + 8 * n + 2 * t)) =
            make_float2(wv[0], wv[1]);
      }
    }
    __syncthreads();

    // G += (W + W^T)_ab F_b: the warp's 16 rows x CP / 2 channels, K = 64,
    // each k step's products promoted into G
#pragma unroll
    for (int k0 = 0; k0 < kTile; k0 += 8) {
      const FragA af = a_frag<kTile>(w, rl, k0, t);
#pragma unroll
      for (int n = 0; n < kNG; ++n) {
        const int c = wn * (CP / 2) + 8 * n + g;
        tf32x3::mma3_promote(gacc[n], af,
                             tf32x3::split_b(fbs[sw<CP>(k0 + 2 * t, c)],
                                             fbs[sw<CP>(k0 + 2 * t + 1, c)]));
      }
    }
    __syncthreads();  // w and this slot are consumed
  }
  tf32x3::cp_async_wait<0>();  // an empty slice still staged F_a

  float* out = a.out0 + ((size_t)blockIdx.y * gridDim.z + blockIdx.z) * M * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = a0 + rl + 8 * h;
    if (i >= M) continue;
#pragma unroll
    for (int n = 0; n < kNG; ++n) {
      const int c = wn * (CP / 2) + 8 * n + 2 * t;
      if (c < C)
        *reinterpret_cast<float2*>(out + (size_t)i * C + c) =
            make_float2(gacc[n][2 * h], gacc[n][2 * h + 1]);
    }
  }
}

// grad = sum over slices of the partials, in slice order: (n4 float4s).
__global__ void __launch_bounds__(kThreads)
gram_bwd_reduce_kernel(const float4* __restrict__ part,
                       float4* __restrict__ grad, long long n4, int slices) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    float4 s = part[i];
    for (int k = 1; k < slices; ++k) {
      const float4 p = part[k * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    grad[i] = s;
  }
}

template <typename K>
int launch(K kernel, size_t smem, dim3 grid, const Args& args,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

int row_tiles(int M) { return (M + kTile - 1) / kTile; }

template <int V, int CP>
int fwd(int B, const Args& args, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)CP * kLd + 2 * kTile) * sizeof(float);
  return launch(gram_fwd_kernel<V, CP>, smem,
                dim3((unsigned)row_tiles(args.M), (unsigned)B), args, stream);
}

template <int V, int CP>
int bwd(int B, int slices, const Args& args, cudaStream_t stream) {
  const size_t smem = (3 * (size_t)kTile * CP + 2 * kData * kTile +
                       (size_t)kTile * kTile) * sizeof(float);
  return launch(gram_bwd_kernel<V, CP>, smem,
                dim3((unsigned)row_tiles(args.M), (unsigned)slices,
                     (unsigned)B),
                args, stream);
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
         static_cast<float*>(out2), static_cast<float*>(out3), M, C, inv_t, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, [&](auto v) {
    return by_width(C, [&](auto cp) {
      return fwd<decltype(v)::value, decltype(cp)::value>(B, a, s);
    });
  });
}

// The fused backward: the column tiles are cut into `slices` ranges of
// `per` tiles (slices * per >= ceil(M / 64)); out is the (B, M, C)
// gradient when slices == 1, else a (slices, B, M, C) scratch of partials
// for gram_stats_bwd_reduce_f32. Cotangents g0, g1, g2 and mx as in Args.
extern "C" int gram_stats_bwd_f32(int variant, const void* f, const void* pos,
                                  const void* other, const void* g0,
                                  const void* g1, const void* g2,
                                  const void* mx, void* out, int slices,
                                  int per, int B, int M, int C, float inv_t,
                                  int device, void* stream) {
  const int err = check(variant, B, M, C, device);
  if (err) return err;
  if (slices < 1 || slices > 65535 || per < 1 ||
      (long long)slices * per < row_tiles(M))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(f), static_cast<const float*>(pos),
         static_cast<const float*>(other), static_cast<const float*>(g0),
         static_cast<const float*>(g1), static_cast<const float*>(g2),
         static_cast<const float*>(mx), static_cast<float*>(out), nullptr,
         nullptr, nullptr, M, C, inv_t, per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, [&](auto v) {
    return by_width(C, [&](auto cp) {
      return bwd<decltype(v)::value, decltype(cp)::value>(B, slices, a, s);
    });
  });
}

// grad (n floats, n % 4 == 0) = sum_k part[k] over `slices` partials of n
// floats each, in the order k = 0, 1, ...
extern "C" int gram_stats_bwd_reduce_f32(const void* part, void* grad,
                                         int slices, long long n, int device,
                                         void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (slices < 1 || n < 4 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const long long blocks = std::min<long long>((n4 + kThreads - 1) / kThreads,
                                               4096);
  gram_bwd_reduce_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(part), static_cast<float4*>(grad), n4,
      slices);
  return (int)cudaGetLastError();
}
