"""Fused SAME conv3d k(3,3,3), dilation (1,d,d), optional ReLU — the 3D
feature head's layer.

Port of the TPU kernel ``cet_pick_tpu/ops/pallas_head.py:95``
(``ztap_dilated_conv``), at the same signature and layout:
``x (B, D, H, W, C)``, ``kernel (3, 3, 3, C, F)`` -> ``(B, D, H, W, F)``.

* ``ztap_dilated_conv`` is the wrapper. A CUDA tensor launches the
  hand-written Hopper kernel in ``csrc/ztap_conv.cu`` (an implicit GEMM on
  the tensor cores in 3xTF32, built by nvcc at first use, see
  ``ops/_build.py``) and adds one to ``ztap_dilated_conv.launches``; a CPU
  tensor takes the plain version. Any other input raises.
* ``ztap_dilated_conv_plain`` is the plain PyTorch version: the z-tap form
  of the JAX ``_ZTapDilatedConv`` (models/detector.py:56-79) — one 2D
  dilated conv with 3F outputs, then a shifted z-add, then the ReLU. The CPU
  path and the card-side comparison use it; training uses it with autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cet_pick_tpu_torch.ops._build import load_library

_KERNEL_GROUP = 32  # the CUDA kernel takes F = 16 or a multiple of this
_MAX_DILATION = 8  # and a halo of at most this many pixels


def ztap_dilated_conv_plain(x, kernel, *, dilation: int = 4,
                            relu: bool = True):
    """Plain PyTorch z-tap form; same arguments and result as the wrapper."""
    b, d, h, w, c = x.shape
    f = kernel.shape[-1]
    # (kz, ky, kx, c, f) -> (kz*F + f, c, ky, kx): output blocks by z offset
    k2 = kernel.permute(0, 4, 3, 1, 2).reshape(3 * f, c, 3, 3)
    u = F.conv2d(x.reshape(b * d, h, w, c).permute(0, 3, 1, 2), k2,
                 padding=dilation, dilation=dilation)
    u = u.reshape(b, d, 3, f, h, w)
    # y[z] = u[z-1, dz=0] + u[z, dz=1] + u[z+1, dz=2]; the zero pad at the
    # z borders reproduces conv3d's SAME padding exactly
    up = F.pad(u, (0, 0, 0, 0, 0, 0, 0, 0, 1, 1))
    y = up[:, :-2, 0] + up[:, 1:-1, 1] + up[:, 2:, 2]
    y = y.permute(0, 1, 3, 4, 2).contiguous()
    return torch.relu(y) if relu else y


@functools.cache
def _cuda_fn():
    fn = load_library("ztap_conv").ztap_dilated_conv_f32
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
    if x.dtype != torch.float32 or kernel.dtype != torch.float32:
        raise TypeError(
            f"ztap_dilated_conv runs float32 only (got {x.dtype}, "
            f"{kernel.dtype}); a bfloat16 kernel is not ported yet")
    if x.device != kernel.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("ztap_dilated_conv wants contiguous x and kernel")


def ztap_dilated_conv(x, kernel, *, dilation: int = 4, relu: bool = True):
    """Fused SAME conv3d k(3,3,3) dil(1, dilation, dilation) (+ ReLU).

    x: (B, D, H, W, C) float32; kernel: (3, 3, 3, C, F) float32 (the JAX
    ``nn.Conv`` layout). Any H and W. Returns a contiguous (B, D, H, W, F).
    """
    _check(x, kernel)
    if x.device.type == "cpu":
        return ztap_dilated_conv_plain(x, kernel, dilation=dilation,
                                       relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"ztap_dilated_conv runs on cuda or cpu, not "
                         f"{x.device}")
    b, d, h, w, c = x.shape
    f = kernel.shape[-1]
    if not (f == 16 or f % _KERNEL_GROUP == 0) or c % 4 \
            or not 1 <= dilation <= _MAX_DILATION:
        raise ValueError(
            f"the CUDA kernel takes F = 16 or a multiple of {_KERNEL_GROUP}, "
            f"C % 4 == 0 and 1 <= dilation <= {_MAX_DILATION} (got C={c}, "
            f"F={f}, dilation={dilation})")
    if x.data_ptr() % 16 or kernel.data_ptr() % 16:
        raise ValueError("ztap_dilated_conv wants 16-byte aligned tensors")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("the CUDA z-tap kernel is inference-only (no "
                           "backward); call it under torch.no_grad()")
    y = torch.empty((b, d, h, w, f), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _cuda_fn()(x.data_ptr(), kernel.data_ptr(), y.data_ptr(),
                     b, d, h, w, c, f, int(dilation), int(relu),
                     x.device.index, stream)
    if err:
        raise RuntimeError(f"ztap_dilated_conv kernel launch failed: CUDA "
                           f"error {err}")
    ztap_dilated_conv.launches += 1
    return y


ztap_dilated_conv.launches = 0
