"""The 3xTF32 products of the port's tensor-core kernels
(``cet_pick_tpu_torch/csrc/tf32x3.cuh``), emulated on the CPU against
float64.

Each float32 operand is split as hi = tf32(x), lo = tf32(x - hi), where
tf32 rounds to nearest with ties away from zero and keeps 10 mantissa bits
(``cvt.rna.tf32.f32``); a product is lo.hi + hi.lo + hi.hi, each term summed
in float32 over the mma's k depth of 8 and added to a float32 accumulator,
in the kernels' K order. These tests pin the tolerance reasoning before the
card sees it: the emulated error of one z-tap output at C = 128 and of one
gram-backward row at M = 2048, C = 32 sits well inside the card's bars
(z-tap 1e-4 absolute; gram gradient rtol 3e-4, atol 3e-5 of the largest
element), where a single TF32 product would not.
"""

import numpy as np
import pytest

F32 = np.float32
ZTAP_TOL = 1e-4           # chip_smoke.py, tests/test_torch_ztap_conv.py
GRAD_RTOL, GRAD_ATOL = 3e-4, 3e-5  # chip_smoke.py GRAM_GRAD
TEMP = 0.07


def tf32(x):
    """Round float32 to tf32 as cvt.rna.tf32.f32 does: nearest, ties away
    from zero, the low 13 mantissa bits cleared."""
    bits = np.asarray(x, dtype=F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, dtype=F32) - hi)


def mma_sum(a, b, passes):
    """sum_k a[..., k] b[k, ...] as the kernels take it: for each k step of
    8, each (a-part, b-part) pass adds its float32 sum of 8 exact products
    to a float32 accumulator."""
    acc = np.zeros(a.shape[:-1] + b.shape[1:], F32)
    for k0 in range(0, a.shape[-1], 8):
        for pa, pb in passes:
            step = (pa[..., k0:k0 + 8].astype(F32)
                    @ pb[k0:k0 + 8].astype(F32)).astype(F32)
            acc = (acc + step).astype(F32)
    return acc


def dot3(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return mma_sum(ah, bh, [(al, bh), (ah, bl), (ah, bh)])


def dot1(a, b):
    return mma_sum(tf32(a), tf32(b), [(tf32(a), tf32(b))])


def test_tf32_rounds_to_nearest_ties_away():
    one = F32(1.0)
    half_ulp = F32(2.0 ** -11)  # halfway between 1 and 1 + 2^-10
    assert tf32(one + half_ulp) == F32(1 + 2.0 ** -10)
    assert tf32(-(one + half_ulp)) == F32(-(1 + 2.0 ** -10))
    assert tf32(one + half_ulp * F32(0.5)) == one
    assert tf32(F32(3.0)) == F32(3.0)


def test_split_keeps_21_bits():
    x = np.random.default_rng(0).standard_normal(100_000).astype(F32)
    hi, lo = split(x)
    assert not np.any(hi.view(np.uint32) & 0x1FFF)
    assert not np.any(lo.view(np.uint32) & 0x1FFF)
    err = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert np.all(err <= 2.0 ** -21 * np.abs(x))


def _ztap_operands(seed=0, c=128, f=128, n=64):
    """n outputs' K vectors of the z-tap GEMM at C = F = 128: unit-normal
    x taps against weights of scale 1 / sqrt(27 C) (unit-scale outputs, as
    chip_smoke.py draws them), in the kernel's K order."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 27 * c)).astype(F32)
    b = (rng.standard_normal((27 * c, f)) / np.sqrt(27 * c)).astype(F32)
    return a, b


def test_ztap_output_at_c128_within_bar():
    a, b = _ztap_operands()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    err3 = np.abs(dot3(a, b) - exact).max()
    err1 = np.abs(dot1(a, b) - exact).max()
    assert err3 < ZTAP_TOL / 10  # f32 accumulation of 3456 terms: ~4e-6
    assert err1 > ZTAP_TOL  # one TF32 product would break the bar


def _gram_row_grad(f, pos, other, g, i, dot):
    """Row i of the ROW backward, dF_i = sum_j (w_ij + w_ji) f_j, with the
    sims and the product by ``dot`` and the epilogue in float32."""
    m = f.shape[0]
    inv_t = F32(1.0 / TEMP)
    s = dot(f[i:i + 1], f.T)[0]
    e = np.exp((s * inv_t - inv_t).astype(F32)).astype(F32)
    w = (e * ((g[0][i] * pos + g[1][i] * other + g[2][i])
              + (g[0] * pos[i] + g[1] * other[i] + g[2])) * inv_t).astype(F32)
    w[i] = 0
    assert w.shape == (m,)
    return dot(w[None], f)[0]


@pytest.mark.parametrize("row", [0, 777])
def test_gram_backward_row_at_m2048_within_bar(row):
    rng = np.random.default_rng(1)
    m, c = 2048, 32
    f = rng.standard_normal((m, c)).astype(F32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    pos = (rng.random(m) < 0.05).astype(F32)
    other = 1 - pos
    g = [rng.standard_normal(m).astype(F32) for _ in range(3)]
    f64 = f.astype(np.float64)
    s = f64[row] @ f64.T
    e = np.exp(s / TEMP - 1 / TEMP)
    w = e * ((g[0][row] * pos + g[1][row] * other + g[2][row])
             + (g[0] * pos[row] + g[1] * other[row] + g[2])) / TEMP
    w[row] = 0
    exact = w @ f64
    got = _gram_row_grad(f, pos, other, g, row, dot3)
    bar = GRAD_RTOL * np.abs(exact) + GRAD_ATOL * max(1.0, np.abs(exact).max())
    assert np.all(np.abs(got - exact) < bar / 10)
