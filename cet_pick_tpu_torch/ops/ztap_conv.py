"""Fused SAME conv3d k(3,3,3), dilation (1,d,d), optional ReLU — the 3D
feature head's layer.

Port of the TPU kernel ``cet_pick_tpu/ops/pallas_head.py:95``
(``ztap_dilated_conv``), at the same signature and layout:
``x (B, D, H, W, C)``, ``kernel (3, 3, 3, C, F)`` -> ``(B, D, H, W, F)``.
The kernel is the float32 parameter; x is float32, or bfloat16 under
``--dtype bfloat16``, and the result has x's dtype.

* ``ztap_dilated_conv`` is the wrapper. A CUDA tensor launches a
  hand-written Hopper kernel in ``csrc/ztap_conv.cu``, built by nvcc at
  first use (``ops/_build.py``): float32 x the 3xTF32 implicit GEMM, which
  adds one to ``ztap_dilated_conv.launches``; bfloat16 x the bf16 one
  (wgmma fed by TMA; ``ztap_dilated_conv_bf16``, its own count). A CPU
  tensor takes the plain version. Any other input raises.
* Widths: the kernels run every ``--head_conv`` width that JAX runs. A
  CUDA tensor of a width off a kernel's instantiations is padded with
  zeros up to one (``kernel_widths(c, f, dtype)``: the float32 kernel
  takes C % 4 == 0 and F = 16 or a multiple of 32, the bfloat16 kernel
  C % 8 == 0, TMA's 16-byte strides, and any F); zero channels and zero
  outputs add nothing, so the result is the unpadded one. Padding x's
  channels copies x, and padding F writes F's pad and then copies the
  first F outputs out. Both kernels take 1 <= dilation <= 8; another
  dilation raises on the card.
* ``ztap_dilated_conv_plain`` is the plain PyTorch version: the z-tap form
  of the JAX ``_ZTapDilatedConv`` (models/detector.py:56-79) — one 2D
  dilated conv with 3F outputs, then a shifted z-add, then the ReLU. The CPU
  path and the card-side comparison use it; training uses it with autograd.
  In bfloat16 it rounds where JAX does: x and the kernel to bf16, each z
  offset's f32 sum to bf16, then ``bf16(bf16(u0 + u1) + u2)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cet_pick_tpu_torch.ops._build import load_library

_F32_GROUP = 32  # the float32 kernel takes F = 16 or a multiple of this
_MAX_DILATION = 8  # the kernels take a halo of at most this many pixels
# The bar of a bf16 z-tap against another computation of it (the kernel
# against its plain version, the plain version against JAX's). Only the
# order of the f32 sums behind each rounding differs; that moves a
# rounding by one bf16 ulp where a sum lies near a rounding boundary, and
# the adds after it carry that on. An element passes five roundings (u0,
# u1, u2, s = u0 + u1, y = s + u2; the ReLU adds none), and two roundings
# of values a and b differ by at most |a - b| plus an ulp, so two
# computations of an element differ by at most the sum of one ulp of each
# of its rounded terms (``bf16_rounding_allowance``). The ulp of y alone is
# no unit: the z-add cancels, and a flipped u0 of ~1 moves a y of ~1e-3 by
# ~250 of y's own ulps. The bar: at least BF16_EQUAL_SHARE of the elements
# bit-equal, and every element within its allowance.
BF16_EQUAL_SHARE = 0.99


def _bf16_ulp(t):
    """One bf16 ulp at |t| (float32), taken a little above |t| so that a
    term one or two ulps below a power of two gets the ulp above it, where
    the other computation's term may lie."""
    mag = (t.float().abs() * (1 + 2.0 ** -6)).clamp_min(
        torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_rounding_allowance(x, kernel, *, dilation: int = 4):
    """Elementwise the sum of one bf16 ulp of each rounded term of the bf16
    z-tap's sum (u0, u1, u2, bf16(u0 + u1), y), (B, D, H, W, F) float32:
    the most two computations that differ only in the order of their f32
    sums can differ by (the comment above)."""
    u0, u1, u2 = _planes(x, kernel, dilation)
    s = u0 + u1
    total = sum(_bf16_ulp(t) for t in (u0, u1, u2, s, s + u2))
    return total.permute(0, 1, 3, 4, 2)


def bf16_agreement(got, want, allowance):
    """(share of elements bit-equal, the worst |got - want| as a share of
    its element's allowance, ok) of two bf16 z-tap results, against the bar
    above."""
    diff = (got.float() - want.float()).abs()
    share = float((diff == 0).float().mean())
    worst = float((diff / allowance).max()) if got.numel() else 0.0
    return share, worst, share >= BF16_EQUAL_SHARE and worst <= 1.0


def _planes(x, kernel, dilation):
    """The z-tap's three shifted planes u[z-1, 0], u[z, 1], u[z+1, 2],
    each (B, D, F, H, W) in x's dtype: f32 sums of x and the kernel (cast to
    bf16 first under bfloat16), rounded to x's dtype."""
    b, d, h, w, c = x.shape
    f = kernel.shape[-1]
    dtype = x.dtype
    if dtype == torch.bfloat16:  # f32 sums of the bf16 values
        x, kernel = x.float(), kernel.to(dtype).float()
    # (kz, ky, kx, c, f) -> (kz*F + f, c, ky, kx): output blocks by z offset
    k2 = kernel.permute(0, 4, 3, 1, 2).reshape(3 * f, c, 3, 3)
    u = F.conv2d(x.reshape(b * d, h, w, c).permute(0, 3, 1, 2), k2,
                 padding=dilation, dilation=dilation)
    u = u.reshape(b, d, 3, f, h, w).to(dtype)
    # y[z] = u[z-1, dz=0] + u[z, dz=1] + u[z+1, dz=2]; the zero pad at the
    # z borders reproduces conv3d's SAME padding exactly
    up = F.pad(u, (0, 0, 0, 0, 0, 0, 0, 0, 1, 1))
    return up[:, :-2, 0], up[:, 1:-1, 1], up[:, 2:, 2]


def ztap_dilated_conv_plain(x, kernel, *, dilation: int = 4,
                            relu: bool = True):
    """Plain PyTorch z-tap form; same arguments and result as the wrapper.
    The planes are added in x's dtype in JAX's order, rounding after each
    add."""
    u0, u1, u2 = _planes(x, kernel, dilation)
    y = (u0 + u1 + u2).permute(0, 1, 3, 4, 2).contiguous()
    return torch.relu(y) if relu else y


@functools.cache
def _cuda_fn(suffix):
    fn = getattr(load_library("ztap_conv"), f"ztap_dilated_conv_{suffix}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, kernel):
    if x.dim() != 5 or kernel.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"ztap_dilated_conv wants x (B,D,H,W,C) and kernel (3,3,3,C,F); "
            f"got {tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.shape[3] != x.shape[4]:
        raise ValueError(f"kernel has C={kernel.shape[3]}, x has "
                         f"C={x.shape[4]}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or kernel.dtype != torch.float32:
        raise TypeError(
            f"ztap_dilated_conv takes float32 or bfloat16 x and a float32 "
            f"kernel (got {x.dtype}, {kernel.dtype})")
    if x.device != kernel.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ztap_dilated_conv runs on cuda or cpu, not "
                         f"{x.device}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("ztap_dilated_conv wants contiguous x and kernel")


def kernel_widths(c, f, dtype=torch.float32):
    """(C, F) at which the CUDA kernel of ``dtype`` runs a z-tap of C =
    ``c`` inputs and F = ``f`` outputs: C up to a multiple of 4 (float32)
    or 8 (bfloat16), and F, float32 only, up to 16 or a multiple of 32.
    The wrappers pad with zeros to these widths."""
    if dtype == torch.bfloat16:
        return -(-c // 8) * 8, f
    fp = 16 if f <= 16 else -(-f // _F32_GROUP) * _F32_GROUP
    return -(-c // 4) * 4, fp


def _padded(x, kernel, cp, fp):
    """x and the kernel with zero channels up to C = ``cp`` and zero
    outputs up to F = ``fp``."""
    c, f = kernel.shape[3], kernel.shape[4]
    if cp != c:
        x = F.pad(x, (0, cp - c))
    if cp != c or fp != f:
        kernel = F.pad(kernel, (0, fp - f, 0, cp - c))
    return x, kernel


def _check_dilation(dilation):
    if not 1 <= dilation <= _MAX_DILATION:
        raise ValueError(f"the CUDA z-tap kernels take 1 <= dilation <= "
                         f"{_MAX_DILATION}, got {dilation}")


def ztap_dilated_conv(x, kernel, *, dilation: int = 4, relu: bool = True):
    """Fused SAME conv3d k(3,3,3) dil(1, dilation, dilation) (+ ReLU).

    x: (B, D, H, W, C) float32 or bfloat16; kernel: (3, 3, 3, C, F)
    float32 (the JAX ``nn.Conv`` layout). Any H and W. Returns a contiguous
    (B, D, H, W, F) of x's dtype.
    """
    _check(x, kernel)
    if x.dtype == torch.bfloat16:
        return ztap_dilated_conv_bf16(x, kernel, dilation=dilation, relu=relu)
    if x.device.type == "cpu":
        return ztap_dilated_conv_plain(x, kernel, dilation=dilation,
                                       relu=relu)
    _check_dilation(dilation)
    f = kernel.shape[4]
    x, kernel = _padded(x, kernel, *kernel_widths(x.shape[4], f))
    y = _launch(x, kernel, kernel.shape[4], "f32", dilation, relu)
    ztap_dilated_conv.launches += 1
    return y if y.shape[4] == f else y[..., :f].contiguous()


def ztap_dilated_conv_bf16(x, kernel, *, dilation: int = 4,
                           relu: bool = True):
    """The bfloat16 z-tap: x (B, D, H, W, C) bf16, kernel (3, 3, 3, C, F)
    float32, cast to bf16 here as JAX casts it. A CUDA tensor launches the
    bf16 kernel and adds one to ``ztap_dilated_conv_bf16.launches``; a CPU
    tensor takes the plain version."""
    _check(x, kernel)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ztap_dilated_conv_bf16 takes bfloat16 x (got "
                        f"{x.dtype})")
    if x.device.type == "cpu":
        return ztap_dilated_conv_plain(x, kernel, dilation=dilation,
                                       relu=relu)
    _check_dilation(dilation)
    x, kernel = _padded(x, kernel, *kernel_widths(
        x.shape[4], kernel.shape[4], torch.bfloat16))
    plan = _bf16_plan(x.shape[4], kernel.shape[4], int(dilation))
    y = _launch(x, _pack_bf16(kernel, *plan), kernel.shape[4], "bf16",
                dilation, relu)
    ztap_dilated_conv_bf16.launches += 1
    return y


@functools.cache
def _bf16_plan(c, f, dilation):
    """(walk, n): how the bf16 kernel runs C = c, F = f at ``dilation``
    (``ztap_dilated_conv_bf16_plan`` in csrc/ztap_conv.cu): a walk over
    runs of slices with FN = n outputs a z offset, or one output slice a
    tile with outputs in groups of n."""
    fn = load_library("ztap_conv").ztap_dilated_conv_bf16_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    err = fn(c, f, dilation, out)
    if err:
        raise RuntimeError(f"ztap_dilated_conv_bf16 takes no plan for C={c}, "
                           f"F={f}, dilation={dilation}: CUDA error {err}")
    return bool(out[0]), int(out[1])


def _pack_bf16(kernel, walk, n):
    """The float32 kernel (3, 3, 3, C, F) in bf16 as the bf16 kernel stages
    it (``_bf16_plan``), zeros past C and F. C is cut into chunks of 32
    channels, each two k16 steps (h) of two planes of 8 channels. The walk
    keeps (chunk, h, plane, tap, kz FN + f, channel) resident, FN = n; one
    output slice a tile stages (group, kz, ky, chunk, h, plane, kx, f,
    channel) a (kz, ky, chunk) at a time, groups of n outputs."""
    c, f = kernel.shape[3], kernel.shape[4]
    chunks = -(-c // 32)
    groups = 1 if walk else -(-f // n)
    k = F.pad(kernel.to(torch.bfloat16),
              (0, groups * n - f, 0, chunks * 32 - c))
    k = k.reshape(3, 3, 3, chunks, 2, 2, 8, groups, n)
    if walk:  # (chunk, h, plane, ky, kx, kz, f, channel)
        return k[..., 0, :].permute(3, 4, 5, 1, 2, 0, 7, 6).reshape(
            chunks, 2, 2, 9, 3 * n, 8).contiguous()
    return k.permute(7, 0, 1, 3, 4, 5, 2, 8, 6).contiguous()


def _launch(x, kernel, f, suffix, dilation, relu):
    """Launch the ``suffix`` kernel on CUDA tensors of a shape it takes
    (``kernel`` as that kernel reads it); returns y (B, D, H, W, f)."""
    b, d, h, w, c = x.shape
    if x.data_ptr() % 16 or kernel.data_ptr() % 16:
        raise ValueError("ztap_dilated_conv wants 16-byte aligned tensors")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("the CUDA z-tap kernel is inference-only (no "
                           "backward); call it under torch.no_grad()")
    y = torch.empty((b, d, h, w, f), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _cuda_fn(suffix)(x.data_ptr(), kernel.data_ptr(), y.data_ptr(),
                           b, d, h, w, c, f, int(dilation), int(relu),
                           x.device.index, stream)
    if err:
        raise RuntimeError(f"ztap_dilated_conv ({suffix}) kernel launch "
                           f"failed: CUDA error {err}")
    return y


ztap_dilated_conv.launches = 0
ztap_dilated_conv_bf16.launches = 0
