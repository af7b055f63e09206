"""The bf16 z-tap kernel (``csrc/ztap_conv.cu``, ``ztap_dilated_conv_bf16``)
against its plain version on the card. No JAX here (the card's machine has
none); tests/test_torch_bf16.py holds the plain version to JAX's bf16
z-tap on the CPU:

    python -m pytest --noconftest -m cuda tests/test_torch_ztap_bf16_cuda.py

The bar is ``ops/ztap_conv.bf16_agreement``: at least 99% of the elements
bit-equal, every element within one bf16 ulp of each rounded term of its
sum (the kernel sums each z offset's products in another order than
cuDNN's f32 convolution; a rounding near a boundary then lands an ulp
apart, and the adds carry it on). On the CPU the wrapper takes the plain
version and launches nothing (checked here without a card).
"""

import pytest
import torch

from cet_pick_tpu_torch.ops.ztap_conv import (
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# C = F = 32 and 128 (unet_N's and unetw_N's head), F = 16, C = 48 / 40 /
# 8 (a k16 step half filled), H and W off the 16 x 32 and 8 x 32 tiles,
# D = 1 and 2 (every slice a z border), dilation 1, 4 and 8.
CUDA_CASES = [((2, 5, 37, 45, 32), 32, True, 4),
              ((1, 6, 64, 64, 32), 32, False, 1),
              ((1, 4, 30, 33, 16), 16, True, 8),
              ((1, 5, 37, 45, 128), 128, True, 4),
              ((2, 1, 13, 31, 128), 128, False, 8),
              ((1, 3, 20, 24, 48), 64, False, 1),
              ((1, 2, 21, 70, 32), 32, True, 8),
              ((1, 3, 9, 17, 40), 64, True, 4),
              ((1, 2, 17, 40, 16), 16, False, 4),
              ((1, 3, 11, 35, 8), 96, True, 1)]


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
def test_cuda_bf16_kernel_refuses_what_it_does_not_take(cuda_device):
    x, k = _inputs((1, 3, 16, 16, 12), 32, 5, cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="C % 8"):
        ztap_dilated_conv(x, k)
