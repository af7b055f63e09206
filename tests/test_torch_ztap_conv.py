"""The z-tap head conv of the port (``ops/ztap_conv.py``) against the JAX
package's.

On the CPU the wrapper takes its plain version. It is held against the
Pallas kernel in interpret mode at atol 2e-5 (the bar of
``tests/test_ops.py:254-271``; the Pallas kernel needs H % hb == 0) and
against the XLA ``_ZTapDilatedConv`` (+ReLU) at odd H and W. The CUDA
kernel itself is held against the plain version on the card (marked
``cuda``). The JAX package is imported inside the tests that use it, so
that the ``cuda`` tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ztap_conv.py
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.ops.ztap_conv import (
    ztap_dilated_conv,
    ztap_dilated_conv_plain,
)

torch.set_num_threads(1)


def _inputs(shape, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, shape[-1], f)) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,f", [((2, 5, 32, 32, 8), 16),
                                     ((1, 6, 32, 32, 32), 32)])
def test_matches_pallas_interpret(shape, f, relu):
    jnp = pytest.importorskip("jax.numpy")
    from cet_pick_tpu.ops.pallas_head import ztap_dilated_conv as jax_ztap

    x, k = _inputs(shape, f)
    want = jax_ztap(jnp.asarray(x), jnp.asarray(k), dilation=4, relu=relu,
                    hb=16, interpret=True)
    before = ztap_dilated_conv.launches
    got = ztap_dilated_conv(torch.from_numpy(x), torch.from_numpy(k),
                            dilation=4, relu=relu)
    assert got.shape == shape[:4] + (f,) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    assert ztap_dilated_conv.launches == before == 0  # CPU: no kernel launch


@pytest.mark.parametrize("shape,f", [((2, 5, 37, 45, 32), 32),
                                     ((1, 3, 11, 9, 8), 16)])
def test_matches_xla_ztap_at_odd_extents(shape, f):
    jax = pytest.importorskip("jax")
    from cet_pick_tpu.models.detector import _ZTapDilatedConv as JaxZTap

    x, k = _inputs(shape, f, seed=1)
    mod = JaxZTap(f, dilation=4)
    want = jax.nn.relu(mod.apply({"params": {"kernel": jax.numpy.asarray(k)}},
                                 jax.numpy.asarray(x)))
    got = ztap_dilated_conv(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_plain_matches_direct_conv3d():
    """The z-tap form computes the direct dilated conv3d's sums."""
    x, k = _inputs((2, 4, 20, 24, 8), 8, seed=2)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    ref = torch.nn.functional.conv3d(
        xt.permute(0, 4, 1, 2, 3), kt.permute(4, 3, 0, 1, 2),
        padding=(1, 4, 4), dilation=(1, 4, 4)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(
        ztap_dilated_conv_plain(xt, kt, relu=False), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("bad,err", [
    (lambda x, k: (x.double(), k.double()), TypeError),
    (lambda x, k: (x.bfloat16(), k.bfloat16()), TypeError),
    (lambda x, k: (x[..., :4], k), ValueError),
    (lambda x, k: (x.transpose(2, 3), k), ValueError),
    (lambda x, k: (x[0], k), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    x, k = _inputs((1, 3, 8, 8, 8), 8)
    with pytest.raises(err):
        ztap_dilated_conv(*bad(torch.from_numpy(x), torch.from_numpy(k)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# The tensor-core kernel's tiles are 16 x 32 output pixels at F <= 32 and
# 8 x 32 at F = 64 and 128; the cases put H and W off those tiles,
# put z at the volume's borders (D = 1 and 2: every slice is a border),
# and take C that is not a multiple of the mma's k depth of 8 (44, 4).
CUDA_CASES = [((2, 5, 37, 45, 32), 32, True), ((1, 6, 64, 64, 32), 32, False),
              ((1, 4, 30, 33, 16), 16, True), ((1, 5, 37, 45, 128), 128, True),
              ((1, 3, 20, 24, 44), 64, False), ((1, 2, 21, 70, 32), 32, True),
              ((2, 1, 13, 31, 128), 128, False), ((1, 3, 9, 17, 44), 64, True),
              ((1, 2, 17, 40, 16), 16, False), ((1, 3, 11, 35, 4), 96, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f,relu", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, shape, f, relu):
    x, k = _inputs(shape, f, seed=3)
    xt = torch.from_numpy(x).to(cuda_device)
    kt = torch.from_numpy(k).to(cuda_device)
    before = ztap_dilated_conv.launches
    with torch.no_grad():
        got = ztap_dilated_conv(xt, kt, relu=relu)
        want = ztap_dilated_conv_plain(xt, kt, relu=relu)
    torch.cuda.synchronize()
    assert ztap_dilated_conv.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f", [((1, 4, 70, 90, 32), 32),
                                     ((1, 3, 37, 45, 128), 128)])
def test_cuda_kernel_is_bit_identical(cuda_device, shape, f):
    """Two launches on the same inputs give the same bits: every output's
    sum runs in one fixed order (no atomics, no split-K)."""
    x, k = _inputs(shape, f, seed=4)
    xt = torch.from_numpy(x).to(cuda_device)
    kt = torch.from_numpy(k).to(cuda_device)
    with torch.no_grad():
        first = ztap_dilated_conv(xt, kt)
        second = ztap_dilated_conv(xt, kt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f", [(32, 48), (12, 12), (10, 8), (44, 200)])
def test_cuda_width_off_the_kernel_is_padded(cuda_device, c, f):
    """F off 16 and the multiples of 32 (``--head_conv 48``, 12, 8) and
    C % 4 != 0 are padded with zeros to the float32 kernel's widths
    (``kernel_widths``): one launch, the plain version's result, the
    first F outputs, contiguous."""
    x, k = _inputs((1, 3, 16, 16, c), f)
    x, k = torch.from_numpy(x).to(cuda_device), torch.from_numpy(k).to(
        cuda_device)
    launches = ztap_dilated_conv.launches
    with torch.no_grad():
        got = ztap_dilated_conv(x, k)
        want = ztap_dilated_conv_plain(x, k)
    torch.cuda.synchronize()
    assert ztap_dilated_conv.launches == launches + 1
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
