"""The bf16 z-tap kernel (``csrc/ztap_conv.cu``, ``ztap_dilated_conv_bf16``)
against its plain version on the card. No JAX here (the card's machine has
none); tests/test_torch_bf16.py holds the plain version to JAX's bf16
z-tap on the CPU:

    python -m pytest --noconftest -m cuda tests/test_torch_ztap_bf16_cuda.py

The bar is ``ops/ztap_conv.bf16_agreement``: at least 99% of the elements
bit-equal, every element within one bf16 ulp of each rounded term of its
sum (the kernel sums each z offset's products in another order than
cuDNN's f32 convolution; a rounding near a boundary then lands an ulp
apart, and the adds carry it on). C % 8 != 0 (TMA's 16-byte strides) is
padded with zero channels and launches the kernel. On the CPU the wrapper takes the plain version and
launches nothing, and the weights are packed as the kernel stages them
(both checked here without a card).
"""

import pytest
import torch

from cet_pick_tpu_torch.ops.ztap_conv import (
    _pack_bf16,
    bf16_agreement,
    bf16_rounding_allowance,
    ztap_dilated_conv,
    ztap_dilated_conv_bf16,
    ztap_dilated_conv_plain,
)


def _inputs(shape, f, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).bfloat16()
    k = torch.randn((3, 3, 3, shape[-1], f), generator=gen) \
        / (27 * shape[-1]) ** 0.5
    return x.to(device), k.to(device)


def test_cpu_takes_the_plain_version():
    x, k = _inputs((1, 3, 12, 13, 8), 16, 0, "cpu")
    before = ztap_dilated_conv_bf16.launches
    want = ztap_dilated_conv_plain(x, k)
    for wrapper in (ztap_dilated_conv, ztap_dilated_conv_bf16):
        got = wrapper(x, k)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert ztap_dilated_conv_bf16.launches == before
    with pytest.raises(TypeError, match="bfloat16"):
        ztap_dilated_conv_bf16(x.float(), k)


@pytest.mark.parametrize("walk,n,c,f", [(True, 32, 32, 32), (True, 8, 40, 5),
                                       (False, 128, 128, 128),
                                       (False, 128, 48, 136),
                                       (False, 48, 24, 40)])
def test_bf16_weights_pack_as_the_kernel_stages_them(walk, n, c, f):
    """Every weight lands where csrc/ztap_conv.cu reads it
    (ztap_dilated_conv_bf16_plan's layouts), zeros past C and F."""
    k = torch.randn((3, 3, 3, c, f), generator=torch.Generator()
                    .manual_seed(0))
    got = _pack_bf16(k, walk, n)
    kb = k.bfloat16()
    chunks = -(-c // 32)
    want = torch.zeros_like(got)
    for ci in range(c):
        chunk, h, plane, ch = ci // 32, ci % 32 // 16, ci % 16 // 8, ci % 8
        for fi in range(f):
            for kz in range(3):
                for ky in range(3):
                    for kx in range(3):
                        v = kb[kz, ky, kx, ci, fi]
                        if walk:
                            want[chunk, h, plane, 3 * ky + kx, kz * n + fi,
                                 ch] = v
                        else:
                            want[fi // n, kz, ky, chunk, h, plane, kx,
                                 fi % n, ch] = v
    shape = (chunks, 2, 2, 9, 3 * n, 8) if walk else \
        (-(-f // n), 3, 3, chunks, 2, 2, 3, n, 8)
    assert tuple(got.shape) == shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# C = F = 32 and 128 (unet_N's and unetw_N's head), F = 16, C = 48 / 40 /
# 8 / 24 (a k16 step half filled), F = 8, 24, 48 (a wgmma width of its
# own), 96 and 136 (two output groups of 128, the second mostly empty) and
# 1; H and W off the kernel's tiles (64 pixels wide; 16 rows at F <= 32, 8
# at F <= 64, 4 above) and off the 16 x 32 and 8 x 32 tiles of the earlier
# mma.sync design; D = 1 and 2 (every slice a z border), dilation 1, 2, 4
# and 8.
CUDA_CASES = [((2, 5, 37, 45, 32), 32, True, 4),
              ((1, 6, 64, 64, 32), 32, False, 1),
              ((1, 4, 30, 33, 16), 16, True, 8),
              ((1, 5, 37, 45, 128), 128, True, 4),
              ((2, 1, 13, 31, 128), 128, False, 8),
              ((1, 3, 20, 24, 48), 64, False, 1),
              ((1, 2, 21, 70, 32), 32, True, 8),
              ((1, 3, 9, 17, 40), 64, True, 4),
              ((1, 2, 17, 40, 16), 16, False, 4),
              ((1, 3, 11, 35, 8), 96, True, 1),
              ((1, 3, 19, 70, 32), 8, True, 4),
              ((1, 3, 19, 130, 32), 24, False, 4),
              ((1, 3, 11, 35, 48), 48, True, 4),
              ((2, 2, 13, 66, 48), 136, True, 4),
              ((1, 3, 33, 129, 24), 1, True, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f,relu,dil", CUDA_CASES)
def test_cuda_bf16_kernel_matches_plain(cuda_device, shape, f, relu, dil):
    x, k = _inputs(shape, f, 3, cuda_device)
    before = ztap_dilated_conv_bf16.launches
    with torch.no_grad():
        got = ztap_dilated_conv(x, k, dilation=dil, relu=relu)
        want = ztap_dilated_conv_plain(x, k, dilation=dil, relu=relu)
    torch.cuda.synchronize()
    assert ztap_dilated_conv_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == shape[:4] + (f,)
    share, worst, ok = bf16_agreement(
        got, want, bf16_rounding_allowance(x, k, dilation=dil))
    assert ok, (share, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4, 12))
@pytest.mark.parametrize("shape,f,dil", [((2, 1, 13, 31, 128), 128, 8),
                                         ((1, 2, 17, 40, 16), 16, 4)])
def test_cuda_bf16_kernel_matches_plain_over_seeds(cuda_device, shape, f,
                                                   dil, seed):
    """One or two slices and no ReLU: an output that cancels to ~1e-6 has
    a rounding allowance of a few of its own tiny ulps, so it shows how
    far the kernel's f32 sums stray. With one accumulator for all 72 k16
    steps of a z offset (C = 128) such an element lay 10 allowances off;
    each stage's products now go into a fresh accumulator."""
    x, k = _inputs(shape, f, seed, cuda_device)
    with torch.no_grad():
        got = ztap_dilated_conv(x, k, dilation=dil, relu=False)
        want = ztap_dilated_conv_plain(x, k, dilation=dil, relu=False)
    torch.cuda.synchronize()
    share, worst, ok = bf16_agreement(
        got, want, bf16_rounding_allowance(x, k, dilation=dil))
    assert ok, (share, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f", [((1, 4, 70, 90, 32), 32),
                                     ((1, 3, 37, 45, 128), 128)])
def test_cuda_bf16_kernel_is_bit_identical(cuda_device, shape, f):
    """Every output's sums run in one fixed order: two launches agree."""
    x, k = _inputs(shape, f, 4, cuda_device)
    with torch.no_grad():
        first = ztap_dilated_conv(x, k)
        second = ztap_dilated_conv(x, k)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f", [(12, 12), (12, 48), (4, 8)])
def test_cuda_bf16_width_off_the_kernel_is_padded(cuda_device, c, f):
    """C % 8 != 0 (``--head_conv 12``'s second layer) is padded with zero
    channels to the kernel's width: one launch, the plain version's result
    within the bar."""
    x, k = _inputs((1, 3, 16, 16, c), f, 5, cuda_device)
    launches = ztap_dilated_conv_bf16.launches
    with torch.no_grad():
        got = ztap_dilated_conv(x, k)
        want = ztap_dilated_conv_plain(x, k)
    torch.cuda.synchronize()
    assert ztap_dilated_conv_bf16.launches == launches + 1
    assert got.shape == want.shape and got.is_contiguous()
    share, worst, ok = bf16_agreement(got, want,
                                      bf16_rounding_allowance(x, k))
    assert ok, (share, worst)
