// 3xTF32 products on Hopper's tensor cores, shared by the port's kernels
// (ztap_conv.cu, gram_stats.cu).
//
// A float32 x is split as hi = tf32(x) (round to nearest, ties away, 10
// mantissa bits: cvt.rna.tf32.f32) and lo = tf32(x - hi); x - hi is exact,
// so hi + lo keeps ~21 bits of x. A product a.b is taken as
//   lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// (lo.lo, ~2^-22 of |a||b|, is dropped), each term a tensor-core product
// accumulated in float32: about 2^-21 relative per product, where one
// plain TF32 product keeps ~2^-11. The small terms go first so that they
// are not absorbed by the large one.
//
// The products use mma.sync.m16n8k8 (tf32 in, f32 accumulate): one warp,
// A 16x8 row-major, B 8x8 column-major, C/D 16x8. With g = lane / 4 and
// t = lane % 4, the fragments are (PTX ISA, "Matrix Fragments for
// mma.m16n8k8", .tf32):
//   A: a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B: b0 (k = t, n = g)   b1 (k = t + 4, n = g)
//   C: c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// The k index of a step is only a summation index, so the kernels map
// k = t to element 2t of the step and k = t + 4 to element 2t + 1 (for A
// and B alike): the two elements of a lane's A fragment row are adjacent
// and load as one float2. The kernels stage float32 tiles in shared memory
// (cp.async, a two-stage ring), load fragments as plain floats and split
// them in registers (3 ALU operations an element, shared by every product
// the fragment feeds).

#pragma once

#include <cstdint>

namespace tf32x3 {

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// d += a.b for one m16n8k8 tile, tf32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A and B fragments split into their hi and lo halves.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  const float v[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

// d += a.b in 3xTF32, in the fixed order lo.hi, hi.lo, hi.hi, accumulated
// in d itself. For short sums (a few k steps into a fresh d).
__device__ __forceinline__ void mma3(float d[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The same through a fresh accumulator, for long sums: the three products
// start from zero and their sum is added to d by one rounded f32 add. The
// tensor core aligns its products and C to the largest exponent and
// truncates what falls below f32's mantissa, so a long sum kept in C loses
// ~2^-24 of its own size, biased, at every mma (chip_smoke.py on an H100:
// the z-tap conv without it was 1.7e-4 from the f32 plain version at
// C = F = 128, unit-scale outputs, against a 1e-4 bar; with it 9e-6);
// through a fresh accumulator that loss is relative to one k step's sum,
// and the running sum rounds to nearest.
__device__ __forceinline__ void mma3_promote(float d[4], const FragA& a,
                                             const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// 16-byte global -> shared copy that bypasses registers (cp.async, sm_80+).
// With valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// The same for 4 bytes (cp.async.ca), for arrays with no 16-byte grain.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
