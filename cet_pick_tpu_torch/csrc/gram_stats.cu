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
// C = 32 per sample, the features are 3.1 MB and operations bind, by four
// orders of magnitude. s_ij = s_ji, so the sims need one C-long dot
// product per unordered pair, M^2 C = 1.9e10 FLOP; the forward needs them
// and M^2 / 2 exponentials (M^2 for V2, whose e differs by the row max);
// the backward adds one (W + W^T).F product, 2 M^2 C, since
// dF_a = sum_b (w_ab + w_ba) f_b (the TPU kernel forms three products:
// the sims, W.F and W^T.F). In 3xTF32 on the tensor cores (495 / 3
// TFLOP/s) that is 0.12 ms forward and 0.35 ms backward per sample (dense
// FP32, 67 TFLOP/s: 0.29 / 0.87 ms). Both passes here form the whole sims
// product, tiles (a, b) and (b, a) alike, in 3xTF32 (tf32x3.cuh: each f32
// operand split into tf32 hi and lo, lo.hi + hi.lo + hi.hi), so what
// bounds them is the work around the tensor core: operand staging and
// splits, block barriers, the epilogue (the exponential of every pair on
// the special function unit). On an H100 (chip_smoke.py) the forward
// reaches 19% of that bound at C = 32 and 13% at C = 128, the backward
// 10-14%; switching the parts of an earlier form of the forward off in
// turn found staging, split and barriers the largest, then the product,
// then the epilogue.
//
// Shared by both passes:
//   * one block owns a row tile a and walks the 64-column tiles b of its
//     slice in order, with F_a, F_b and the per-index data staged by
//     cp.async, F_b and the data in a ring;
//   * S = F_a F_b^T (K = C, a few k steps) accumulates in the product's
//     own accumulator (the forward's in one a 32-channel plane, added in
//     f32);
//   * only the tiles that hold the diagonal and the last one test the
//     i == j and j >= M masks;
//   * filling the card: the b tiles are cut into `slices` fixed ranges
//     (grid (row tiles, slices, B)), chosen by the wrapper from the shape
//     alone so that the grid has ~1024 blocks (one block a row tile is 96
//     blocks on 132 SMs at M = 6144). Each slice writes its partials to a
//     scratch tensor the wrapper allocates; a second small kernel combines
//     them in slice order. With one slice the pass writes its outputs
//     itself;
//   * no atomics: every sum has one owner and one order, so results are
//     bit-identical from run to run.
//
// The forward, on wgmma. The TPU kernel kept all features resident in VMEM
// across a sequential grid and split f32 into bf16 hi/lo passes for its
// MXU. Here a block of two warpgroups owns 128 rows (C <= 96; each
// warpgroup 64 rows and all 64 columns of a tile, wgmma m64n64k8) or, at
// C = 128, where the operands of 128 rows exceed shared memory, 64 rows
// (the warpgroups split a tile's columns, m64n32k8, and add their partials
// at the end). Operands sit in shared memory in wgmma's 128-byte-swizzled
// K-major layout (`sw128`): each F_b tile lands raw by cp.async in a
// 3-slot ring (two tiles in flight), the block splits it once in place
// into tf32 hi and a lo copy, and the two warpgroups read both (F_a is
// split once a block). mma.sync, as in the backward, splits each F_b
// element in registers in every warp that reads it, and only wgmma reaches
// the tensor cores' full TF32 rate: a form of this forward on the
// backward's mma.sync pieces took 1.8x this one's time at C = 32, 1.2x at
// C = 128 and 1.5x for V2 (chip_smoke.py's gram phase, one H100). The epilogue works on the accumulator
// fragments in registers, so no sims element reaches shared or device
// memory: each thread keeps per-row partials for its two rows, summed at
// the end over the 4 lanes of a row group (shuffles, a fixed order), and
// at C = 128 over the two warpgroups (warpgroup 0's, then 1's). Each tile is
// issued, waited for and folded in turn: folding tile tb while tile
// tb + 1's products run made ptxas serialize every wgmma (warnings C7514
// and C7515: it counts reads of the other accumulator as a hazard).
// The exponentials run on the special function unit, ex2.approx with
// log2(e) folded into the argument (ROW: one FMA, 2^((s - 1) log2(e)/T)):
// the argument is rounded to f32 either way, and the unit's ~2 ulp add
// ~1e-7 where the sums' bar is rtol 2e-5, so expf's longer sequence (~8
// instructions a pair) buys nothing.
// V2 takes one sweep with an online row max: each thread carries (mx, tot)
// per row; a column tile whose max exceeds mx first rescales tot by
// exp(mx - new max) (expf), then adds exp(s - mx) as 2^((s - mx) log2(e))
// (the difference first, so that a large max adds no rounding); partials
// merge as tot = sum_k tot_k exp(mx_k - mx). The max stays the exact max
// of the computed sims, with the diagonal entering as 0, and the two sims
// sums need no max.
//
// The backward, one fused pass on mma.sync.m16n8k8 (fragments split in
// registers): 8 warps as 4 (rows) x 2 (columns) own a 64-row tile; per
// tile pair it forms w_ab (cotangents of a, masks of b) + w_ba (cotangents
// of b, masks of a) from S in the epilogue — one expf a pair for ROW and
// LOGIT, where e_ab = e_ba; two for V2, whose e differs by the row max —
// into shared memory, and accumulates G_a += (W + W^T)_ab F_b (K = 64) in
// registers: two products, one launch. Tiles are row-major with an XOR
// swizzle (`sw`) so that both of F_b's fragment patterns hit 32 distinct
// banks; at C <= 32 the own rows' split A fragments stay in registers. G,
// the long sum over the slice, takes each k step's 3 products in a fresh
// accumulator that is then added to it (tf32x3.cuh: the tensor core
// truncates what it adds to a large accumulator; once a tile, 24
// products, broke the logit gradient's 3e-5 bar at (2, 1000, 32)). Its
// slices write (slices, B, M, C) partial gradients, summed in slice order.
// wgmma for the backward is later work.

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kTile = 64;      // owned and looped tile extent
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kData = 6;       // per-index rows of the backward's data
constexpr float kLog2e = 1.4426950408889634f;

enum { ROW = 0, LOGIT = 1, V2 = 2 };

struct Args {
  const float* f;      // (B, M, C)
  const float* pos;    // (B, M)
  const float* other;  // (B, M), ROW: other; V2: neg
  const float* g0;     // ROW: g_pos;   LOGIT: g_lsum; V2: g_ps   (B, M)
  const float* g1;     // ROW: g_other; LOGIT: g_tot;  V2: g_ns   (B, M)
  const float* g2;     // ROW: g_tot;                  V2: g_tot  (B, M)
  const float* mx;     // V2 backward: the forward's row max      (B, M)
  float* out0;         // forward: the row stats, (B, M) each with one
  float* out1;         // slice, else (slices, B, M) partials each;
  float* out2;         // backward: the gradient (out0), or its
  float* out3;         // (slices, B, M, C) partials
  int M, C;
  float inv_t;
  int per;             // column tiles per slice
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x on the special function unit (~2 ulp; results below 2^-126 are 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A partial sum of exp(s - mk) taken to the max m >= mk: t exp(mk - m).
// An empty partial (mk = -inf, t = 0) adds 0.
__device__ __forceinline__ float to_max(float t, float mk, float m) {
  return mk == neg_inf() ? 0.f : t * expf(mk - m);
}

// ---- the forward's operands for wgmma -------------------------------------
// A 64 x CP tile (rows x channels, K-major) as wgmma reads it with 128-byte
// swizzling: CP / 32 planes of 64 rows x 32 floats (128 bytes a row), each
// plane 8 atoms of 8 rows x 128 bytes, 1024-byte aligned; the 16-byte chunk
// c of row r of an atom sits at chunk c ^ (r % 8). Float offset of the
// chunk of channels [4 c4, 4 c4 + 4) of row r:
template <int CP>
__device__ __forceinline__ int sw128(int r, int c4) {
  return (c4 / 8) * kTile * 32 + r * 32 + (((c4 % 8) ^ (r & 7)) << 2);
}

// Stage rows [r0, r0 + 64) of one sample's (M, C) features f into such a
// tile by cp.async; rows past M and channels past C are zeros (`any`: a
// valid address for the copies that read nothing).
template <int CP>
__device__ __forceinline__ void stage_rows128(const float* f, int M, int C,
                                              int r0, float* dst,
                                              const float* any) {
  constexpr int kC4 = CP / 4;
  for (int i = threadIdx.x; i < kTile * kC4; i += kThreads) {
    const int r = i / kC4, c4 = i % kC4;
    const bool v = r0 + r < M && 4 * c4 < C;
    tf32x3::cp_async16(dst + sw128<CP>(r, c4),
                       v ? f + (size_t)(r0 + r) * C + 4 * c4 : any, v);
  }
}

// Split staged tiles of n4 16-byte chunks in place: t keeps hi = tf32(x),
// lo gets tf32(x - hi) at the same offsets (both as tf32 bit patterns);
// then make the writes visible to wgmma (the async proxy).
__device__ __forceinline__ void split_tile(float* t, float* lo, int n4) {
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const float4 x = reinterpret_cast<float4*>(t)[q];
    const tf32x3::Split s0 = tf32x3::split(x.x), s1 = tf32x3::split(x.y),
                        s2 = tf32x3::split(x.z), s3 = tf32x3::split(x.w);
    reinterpret_cast<float4*>(t)[q] =
        make_float4(__uint_as_float(s0.hi), __uint_as_float(s1.hi),
                    __uint_as_float(s2.hi), __uint_as_float(s3.hi));
    reinterpret_cast<float4*>(lo)[q] =
        make_float4(__uint_as_float(s0.lo), __uint_as_float(s1.lo),
                    __uint_as_float(s2.lo), __uint_as_float(s3.lo));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled K-major operand at p (shared
// memory): start address >> 4, LBO 1 (unused when an instruction's K fits
// in the swizzle width), SBO 1024 bytes (8 rows), layout 1 (128B swizzle).
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d = a.b + (acc ? d : 0) for the warpgroup: m64nNk8 (N = 64 or 32), tf32
// operands from shared memory, f32 accumulator, asynchronous. Register
// d[4 n + e] is row 16 w + g + 8 (e / 2) and column 8 n + 2 t + (e % 2)
// for warp w of the warpgroup (the m16n8 C fragment of mma.sync, N / 8
// n8 tiles).
__device__ __forceinline__ void wgmma_k8(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}
__device__ __forceinline__ void wgmma_k8(float (&d)[16], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

// d (= or +=) the products of one 32-channel plane p of the split tiles:
// the small terms lo.hi and hi.lo of its 4 k steps first, while d holds
// only them, then hi.hi (the first product overwrites d unless `add`).
template <int D>
__device__ __forceinline__ void plane_wgmma(float (&d)[D], const float* ahi,
                                            const float* alo,
                                            const float* bhi,
                                            const float* blo, int p,
                                            bool add) {
  const int base = p * kTile * 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // k steps of 8 channels, 32 bytes
    const int k = base + 8 * kk;
    wgmma_k8(d, wg_desc(alo + k), wg_desc(bhi + k), add || kk > 0);
    wgmma_k8(d, wg_desc(ahi + k), wg_desc(blo + k), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_k8(d, wg_desc(ahi + base + 8 * kk), wg_desc(bhi + base + 8 * kk),
             1);
}

// S = A B^T for the warpgroup (64 rows x the N = 2 D columns of b, K = CP)
// in 3xTF32 from split tiles (ahi, alo), (bhi, blo); returns when d holds
// it. The tensor core truncates what it adds into an accumulator to the
// accumulator's exponent (tf32x3.cuh), and the ROW / LOGIT epilogues
// multiply an error in s by 1/T: so each 32-channel plane's products go
// into a fresh accumulator, small terms first (`plane_wgmma`), and the
// planes are added in f32. At C = 128 on features training made, one
// accumulator for all 48 products put pos_sum 2x past its bar
// (chip_smoke.py --train-seeds).
template <int CP, int D>
__device__ __forceinline__ void sims_wgmma(float (&d)[D], const float* ahi,
                                           const float* alo, const float* bhi,
                                           const float* blo) {
  auto run = [&](auto& acc, int p) {
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    plane_wgmma(acc, ahi, alo, bhi, blo, p, false);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  };
  run(d, 0);
#pragma unroll
  for (int p = 1; p < CP / 32; ++p) {
    float t[D];
    run(t, p);
#pragma unroll
    for (int i = 0; i < D; ++i) d[i] += t[i];
  }
}

// The forward's row groups a block, 64 rows each: two where their operands
// fit in shared memory, each warpgroup then owns 64 rows and all 64
// columns of a tile; at C = 128 one (A hi / lo of 128 rows and the F_b
// ring exceed shared memory), and the two warpgroups split its columns.
template <int CP>
__host__ __device__ constexpr int fwd_rows() { return CP <= 96 ? 128 : 64; }
constexpr int kFwdStages = 3;  // F_b ring: tile tb, tb + 1, tb + 2

// The forward. The block (8 warps, two warpgroups) owns rows [a0, a0 +
// fwd_rows) and walks the column tiles b of slice blockIdx.y in order. Per
// tile each warpgroup takes its part of S = F_a F_b^T (64 x N) by wgmma
// and folds it into per-row partials in registers. (Issuing tile tb + 1's
// products before tile tb's epilogue made ptxas serialize every wgmma:
// it counts the epilogue's reads of the other accumulator as a hazard.)
// It writes output k of row i to outk + (slice * B + sample) * M + i: the
// output itself with one slice, else that slice's partial.
//   ROW   out0..2 = sum_j e p_j, sum_j e o_j, sum_j e
//   LOGIT out0..1 = sum_j l p_j, sum_j e
//   V2    out0..3 = mx, sum_j s p_j, sum_j s n_j, sum_j exp(s - mx)
// Two blocks an SM at C <= 32 (128 registers a thread), where their shared
// memory fits twice.
template <int V, int CP>
__global__ void __launch_bounds__(kThreads, CP <= 32 ? 2 : 1)
gram_fwd_kernel(Args a) {
  constexpr int kRG = fwd_rows<CP>() / 64;  // row groups
  constexpr int kN = 64 * kRG / 2;          // columns a warpgroup: 64 or 32
  constexpr int kOp = kTile * CP;  // floats of one 64-row operand tile
  extern __shared__ float4 smem4[];
  // the swizzle atoms need 1024-byte alignment (the launch adds 1 KB)
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
  float* const ahi = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + ((1024 - (s0 & 1023)) & 1023));
  float* const alo = ahi + kRG * kOp;  // A: one operand tile a row group
  float* const fb = alo + kRG * kOp;   // the ring: F_b, then its hi in place
  float* const blo = fb + kFwdStages * kOp;  // F_b's lo
  float* const bm = blo + kOp;               // the ring of p, o (2 x kTile)

  const int M = a.M, C = a.C;
  const int a0 = blockIdx.x * 64 * kRG;
  const int tiles = (M + kTile - 1) / kTile;
  const int t_begin = blockIdx.y * a.per;
  const int t_end = min(tiles, t_begin + a.per);
  const size_t base = (size_t)blockIdx.z * M;
  const float* f = a.f + base * C;
  const float inv_t = a.inv_t;
  const float c2 = inv_t * kLog2e;  // ROW: e = 2^(s c2 - c2)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4;
  const int rg = kRG == 2 ? wg : 0;  // the warpgroup's rows, 64 rg + ...
  const int cn = kRG == 2 ? 0 : wg * kN;  // ... and its first column
  const int rl = 64 * rg + 16 * (warp % 4) + g;  // rows a0 + rl, + rl + 8
  const float* const my_ahi = ahi + rg * kOp;
  const float* const my_alo = alo + rg * kOp;

  // stage column tile tb (if it is in the slice) into its ring slot; one
  // commit group either way, so that groups count tiles
  auto stage = [&](int tb) {
    if (tb < t_end) {
      const int slot = (tb - t_begin) % kFwdStages;
      stage_rows128<CP>(f, M, C, tb * kTile, fb + slot * kOp, a.f);
      if (threadIdx.x < 2 * kTile) {  // p, o; zeros past M
        const int j = tb * kTile + threadIdx.x % kTile;
        const bool is_p = threadIdx.x < kTile;
        const bool v = j < M && (is_p || V != LOGIT);
        tf32x3::cp_async4(bm + slot * 2 * kTile + threadIdx.x,
                          v ? (is_p ? a.pos : a.other) + base + j : a.f, v);
      }
    }
    tf32x3::cp_async_commit();
  };

  // per own row h (rl + 8 h): ROW (pos, other, tot); LOGIT (lsum, tot);
  // V2 (pos_sims, neg_sims, tot) with tot against mx[h]
  float acc[2][3], mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = neg_inf();
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[h][k] = 0.f;
  }

  // s[4 n + e] of the tile: row rl + 8 (e / 2), column cn + 8 n + 2 t +
  // (e % 2)
  auto epilogue = [&](int tb, auto& s, auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
    const int b0 = tb * kTile;
    const float* bms = bm + ((tb - t_begin) % kFwdStages) * 2 * kTile;
    float tmx[2] = {neg_inf(), neg_inf()};  // V2: the tile's row max
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int jl = cn + 8 * n + 2 * t + e % 2;
        const bool diag = kMasked && b0 + jl == a0 + rl + 8 * h;
        if (kMasked && b0 + jl >= M) continue;
        const float p = bms[jl];
        float& sv = s[4 * n + e];
        if (V == ROW) {
          const float ex = diag ? 1.f : ex2(fmaf(sv, c2, -c2));
          acc[h][0] = fmaf(ex, p, acc[h][0]);
          acc[h][1] = fmaf(ex, bms[kTile + jl], acc[h][1]);
          acc[h][2] += ex;
        } else if (V == LOGIT) {
          const float l = diag ? 0.f : fmaf(sv, inv_t, -inv_t);
          acc[h][0] = fmaf(l, p, acc[h][0]);
          acc[h][1] += diag ? 1.f : ex2(l * kLog2e);
        } else {
          sv = diag ? 0.f : sv * inv_t;
          tmx[h] = fmaxf(tmx[h], sv);
          acc[h][0] = fmaf(sv, p, acc[h][0]);
          acc[h][1] = fmaf(sv, bms[kTile + jl], acc[h][1]);
        }
      }
    if (V == V2) {
      // a higher max first takes the sum so far to it, then this tile's
      // exp(s - mx) are added against it
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (tmx[h] > mx[h]) {
          acc[h][2] = to_max(acc[h][2], mx[h], tmx[h]);
          mx[h] = tmx[h];
        }
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kMasked && b0 + cn + 8 * n + 2 * t + e % 2 >= M) continue;
          acc[e / 2][2] += ex2((s[4 * n + e] - mx[e / 2]) * kLog2e);
        }
    }
  };

  stage_rows128<CP>(f, M, C, a0, ahi, a.f);  // in the first group
  if (kRG == 2) stage_rows128<CP>(f, M, C, a0 + 64, ahi + kOp, a.f);
  stage(t_begin);
  stage(t_begin + 1);
  for (int tb = t_begin; tb < t_end; ++tb) {
    tf32x3::cp_async_wait<1>();  // tile tb has landed (tb + 1 may not)
    // ... for every thread, and tile tb - 1 (its ring slot, blo) is
    // consumed: stage tile tb + 2 into that slot
    __syncthreads();
    stage(tb + 2);
    float* const bhi = fb + ((tb - t_begin) % kFwdStages) * kOp;
    if (tb == t_begin) split_tile(ahi, alo, kRG * kOp / 4);
    split_tile(bhi, blo, kOp / 4);
    __syncthreads();
    float s[kN / 2];
    // B from row cn of the tile: cn * 32 floats into each plane
    sims_wgmma<CP>(s, my_ahi, my_alo, bhi + cn * 32, blo + cn * 32);
    // only the tiles that hold the block's diagonal and the last one need
    // the i == j and j >= M masks
    const int b0 = tb * kTile;
    if ((b0 + kTile > a0 && b0 < a0 + 64 * kRG) || b0 + kTile > M)
      epilogue(tb, s, std::true_type());
    else
      epilogue(tb, s, std::false_type());
  }
  tf32x3::cp_async_wait<0>();

  // Sum the partials over the 4 lanes of a row group (xor 1, then 2; each
  // lane adds the same two terms, so all four hold the same bits); then,
  // where the two warpgroups split the columns, warpgroup 1's into
  // warpgroup 0's through shared memory (the mask ring, now free).
  constexpr int kPlain = V == ROW ? 3 : 2;  // V2: tot merges by the max
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < kPlain; ++k)
        acc[h][k] += __shfl_xor_sync(0xffffffffu, acc[h][k], off);
      if (V == V2) {
        const float m2 = __shfl_xor_sync(0xffffffffu, mx[h], off);
        const float t2 = __shfl_xor_sync(0xffffffffu, acc[h][2], off);
        const float m = fmaxf(mx[h], m2);
        acc[h][2] = to_max(acc[h][2], mx[h], m) + to_max(t2, m2, m);
        mx[h] = m;
      }
    }
  if (kRG == 1) {
    float* const red = bm;  // kTile x 4
    __syncthreads();        // every epilogue has read its masks
    if (wg == 1 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* r = red + 4 * (rl + 8 * h);
        r[0] = acc[h][0];
        r[1] = acc[h][1];
        r[2] = acc[h][2];
        r[3] = mx[h];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* r = red + 4 * (rl + 8 * h);
#pragma unroll
      for (int k = 0; k < kPlain; ++k) acc[h][k] += r[k];
      if (V == V2) {
        const float m = fmaxf(mx[h], r[3]);
        acc[h][2] = to_max(acc[h][2], mx[h], m) + to_max(r[2], r[3], m);
        mx[h] = m;
      }
    }
  }
  if (t == 0) {
    const size_t o = (size_t)blockIdx.y * gridDim.z * M + base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = a0 + rl + 8 * h;
      if (i >= M) continue;
      if (V == ROW) {
        a.out0[o + i] = acc[h][0];
        a.out1[o + i] = acc[h][1];
        a.out2[o + i] = acc[h][2];
      } else if (V == LOGIT) {
        a.out0[o + i] = acc[h][0];
        a.out1[o + i] = acc[h][1];
      } else {
        a.out0[o + i] = mx[h];
        a.out1[o + i] = acc[h][0];
        a.out2[o + i] = acc[h][1];
        a.out3[o + i] = acc[h][2];
      }
    }
  }
}

// The forward's outputs from its slices' partials, part[(k * slices + s)
// * n + i] for output k, slice s, index i < n = B M, in slice order: plain
// sums; V2's tot first takes each slice's partial to the overall max.
template <int V>
__global__ void __launch_bounds__(kThreads)
gram_fwd_reduce_kernel(const float* __restrict__ part, Args a, long long n,
                       int slices) {
  float* const outs[4] = {a.out0, a.out1, a.out2, a.out3};
  constexpr int kOut = V == ROW ? 3 : V == LOGIT ? 2 : 4;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    auto at = [&](int k, int s) { return part[(k * slices + s) * n + i]; };
#pragma unroll
    for (int k = V == V2 ? 1 : 0; k < (V == V2 ? 3 : kOut); ++k) {
      float sum = at(k, 0);
      for (int s = 1; s < slices; ++s) sum += at(k, s);
      outs[k][i] = sum;
    }
    if (V == V2) {
      float m = at(0, 0);
      for (int s = 1; s < slices; ++s) m = fmaxf(m, at(0, s));
      float tot = to_max(at(3, 0), at(0, 0), m);
      for (int s = 1; s < slices; ++s) tot += to_max(at(3, s), at(0, s), m);
      a.out0[i] = m;
      a.out3[i] = tot;
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
int fwd(int B, int slices, const Args& args, cudaStream_t stream) {
  constexpr int kRows = fwd_rows<CP>();
  // A hi / lo, the F_b ring, F_b's lo, the ring of masks; and 1 KB to
  // align the swizzle atoms
  const size_t smem = ((2 * kRows / 64 + kFwdStages + 1) * (size_t)kTile * CP +
                       2 * kFwdStages * kTile) * sizeof(float) + 1024;
  return launch(gram_fwd_kernel<V, CP>, smem,
                dim3((unsigned)((args.M + kRows - 1) / kRows),
                     (unsigned)slices, (unsigned)B),
                args, stream);
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

int check_slices(int slices, int per, int M) {
  if (slices < 1 || slices > 65535 || per < 1 ||
      (long long)slices * per < row_tiles(M))
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
// The column tiles are cut into `slices` ranges of `per` tiles (slices *
// per >= ceil(M / 64)). With one slice out0..out3 are the outputs; else
// each is the (slices, B, M) partials of its output, and
// gram_stats_fwd_reduce_f32 combines them.
extern "C" int gram_stats_fwd_f32(int variant, const void* f, const void* pos,
                                  const void* other, void* out0, void* out1,
                                  void* out2, void* out3, int slices, int per,
                                  int B, int M, int C, float inv_t,
                                  int device, void* stream) {
  int err = check(variant, B, M, C, device);
  if (!err) err = check_slices(slices, per, M);
  if (err) return err;
  Args a{static_cast<const float*>(f), static_cast<const float*>(pos),
         static_cast<const float*>(other), nullptr, nullptr, nullptr, nullptr,
         static_cast<float*>(out0), static_cast<float*>(out1),
         static_cast<float*>(out2), static_cast<float*>(out3), M, C, inv_t,
         per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_variant(variant, [&](auto v) {
    return by_width(C, [&](auto cp) {
      return fwd<decltype(v)::value, decltype(cp)::value>(B, slices, a, s);
    });
  });
}

// The forward's outputs out0..out3 (n = B M floats each, as
// gram_stats_fwd_f32's) from part, the (outputs, slices, n) partials its
// sliced launch wrote (out_k there = part + k slices n), in slice order.
extern "C" int gram_stats_fwd_reduce_f32(int variant, const void* part,
                                         void* out0, void* out1, void* out2,
                                         void* out3, int slices, long long n,
                                         int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (variant < ROW || variant > V2 || slices < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         static_cast<float*>(out0), static_cast<float*>(out1),
         static_cast<float*>(out2), static_cast<float*>(out3), 0, 0, 0.f, 0};
  const long long blocks = std::min<long long>((n + kThreads - 1) / kThreads,
                                               4096);
  return by_variant(variant, [&](auto v) {
    gram_fwd_reduce_kernel<decltype(v)::value>
        <<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(part), a, n, slices);
    return (int)cudaGetLastError();
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
  int err = check(variant, B, M, C, device);
  if (!err) err = check_slices(slices, per, M);
  if (err) return err;
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
