"""TomoPickNet (``unet_N``) and TomoPickNetW (``unetw_N``) — the refinement
heatmap detectors, port of ``cet_pick_tpu/models/detector.py``.

The reference's production model ``TomoConvUNet`` (reference:
cet_pick/models/networks/unet_small.py:30-113):

    stem Conv2d(1->16, k7, stride 2, padding 3) + BN + ReLU (unet_small.py:35-37)
    per-z-slice 2D UNet (16 -> 32, n_blocks=N)          (:38, :63-76)
    3D feature head: two Conv3d k3 dilation (1,4,4)     (:39-49)
    per-task heads: Conv3d k(3,1,1), no bias            (:53-61)
    'proj' head output L2-normalized over channels      (:88-94)

Attribute names follow the reference state dict (``conv1``, ``bn1``,
``unet.*``, ``feature_head.0``/``.2``, one attribute per head), so reference
``.pth`` files and the JAX package's ``export-torch`` output load with
``strict=True``.

``unetw_N`` (detector.py:156-268) is the JAX package's wide family: a 4x4
patchify stem, a 128-wide UNet trunk, ``FeatureHead3D(128)`` and output
stride 4. It has no reference checkpoint; its state dict keys are the
port's module names (``stem.embed``, ``stem.mix``, ``stem_bn``, then as
``unet_N``), and ``models/convert.state_dict_from_jax`` maps JAX's
parameters onto them.

Layout: the trunk runs NCHW with z folded into the batch; the head works
channels-last, which is what the z-tap kernel takes. The public
``forward`` keeps the JAX layout: input ``(B, D, H, W)``, output
``{head: (B, D, H//s, W//s, C)}`` with s = ``stem_stride``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from cet_pick_tpu_torch.models.flax_init import flax_init_, lecun_normal_
from cet_pick_tpu_torch.models.unet import BatchNorm2d, UNet2D
from cet_pick_tpu_torch.ops.ztap_conv import (
    ztap_dilated_conv,
    ztap_dilated_conv_plain,
)


class _Stem(nn.Conv2d):
    """k7 s2 stem conv with explicit padding (3, 3) (detector.py:291-295).

    The JAX package lowers it through a space-to-depth phase conv
    (detector.py:82-134), a TPU-only trick for MXU occupancy; a plain
    ``Conv2d`` computes the same sums."""

    def __init__(self, features: int = 16):
        super().__init__(1, features, 7, stride=2, padding=3, bias=False)


class _ZTapDilatedConv(nn.Module):
    """k(3,3,3) dilation-(1,d,d) 3D conv, bias-free, in the plain z-tap form
    (JAX ``_ZTapDilatedConv``, detector.py:35-79).

    ``weight`` has ``nn.Conv3d``'s layout ``(F, C, 3, 3, 3)``; ``kernel()``
    gives the JAX layout ``(3, 3, 3, C, F)`` that the z-tap kernel takes."""

    def __init__(self, in_features: int, features: int, dilation: int = 4):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(features, in_features, 3, 3, 3))
        lecun_normal_(self.weight, 27 * in_features)  # flax's, as JAX's

    def kernel(self):
        return self.weight.permute(2, 3, 4, 1, 0).contiguous()

    def forward(self, x, relu: bool = False):
        """x: (B, D, H, W, C) -> (B, D, H, W, F), differentiable."""
        return ztap_dilated_conv_plain(x, self.kernel(),
                                       dilation=self.dilation, relu=relu)


class FeatureHead3D(nn.Module):
    """Two dilated 3D convs, each followed by ReLU (unet_small.py:39-49).

    In eval mode each layer is one call of the fused z-tap kernel
    (``ops/ztap_conv.ztap_dilated_conv``: the CUDA kernel on the card, its
    plain version on the CPU). In train mode it runs the plain z-tap form
    with autograd, as the JAX package trains through its XLA form.

    The two convs are the children ``0`` and ``2``, the indices of the
    reference's ``Sequential(conv, ReLU, conv, ReLU)``."""

    def __init__(self, in_features: int = 32, features: int = 32):
        super().__init__()
        self.add_module("0", _ZTapDilatedConv(in_features, features))
        self.add_module("2", _ZTapDilatedConv(features, features))

    def forward(self, x):
        for conv in (self._modules["0"], self._modules["2"]):
            if self.training:
                x = conv(x, relu=True)
            else:
                x = ztap_dilated_conv(x, conv.kernel(),
                                      dilation=conv.dilation, relu=True)
        return x


class _Detector(nn.Module):
    """Stem + slice-wise 2D UNet + dilated 3D head + per-task heads; the
    subclasses build the stem, the trunk and ``feature_head``."""

    def _add_heads(self, heads, head_conv):
        self.heads = dict(heads)
        for head, classes in self.heads.items():
            self.add_module(head, nn.Conv3d(head_conv, classes, (3, 1, 1),
                                            padding=(1, 0, 0), bias=False))

    def forward(self, x, active_heads=None):
        """x: (B, D, H, W) -> {head: (B, D, H', W', C)}.

        active_heads: optional subset of the heads to compute (whole-volume
        picking needs only 'hm')."""
        b, d, h, w = x.shape
        x = F.relu(self._stem(x.reshape(b * d, 1, h, w)), inplace=True)
        x = self.unet(x)
        hh, ww = x.shape[-2:]
        # (B*D, C, H', W') -> channels-last (B, D, H', W', C) for the head
        x = x.permute(0, 2, 3, 1).contiguous().reshape(b, d, hh, ww, -1)
        return self._apply_heads(self.feature_head(x), active_heads)

    def _apply_heads(self, x, active_heads=None):
        """Channels-last (B, D, H, W, C) features -> {head: (B, D, H, W, K)};
        'proj' L2-normalized over its channels."""
        out = {}
        for head in self.heads:
            if active_heads is not None and head not in active_heads:
                continue
            # k(3,1,1) conv on the channels-last tensor viewed as NCDHW
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), self._modules[head].weight,
                         padding=(1, 0, 0)).permute(0, 2, 3, 4, 1)
            if "proj" in head:
                y = y / torch.linalg.vector_norm(
                    y, dim=-1, keepdim=True).clamp_min(1e-12)
            out[head] = y
        return out


class TomoPickNet(_Detector):
    """``unet_N``: k7 s2 stem, 32-wide trunk, output stride 2."""

    stem_stride = 2  # output stride; read by infer/tiled for xy geometry

    def __init__(self, heads: Dict[str, int], n_blocks: int = 4,
                 head_conv: int = 32, stem_features: int = 16):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv1 = _Stem(stem_features)
        self.bn1 = BatchNorm2d(stem_features)
        self.unet = UNet2D(n_blocks, start_filts=32, out_channels=32,
                           in_channels=stem_features)
        self.feature_head = FeatureHead3D(32, head_conv)
        self._add_heads(heads, head_conv)
        flax_init_(self)

    def _stem(self, x):
        return self.bn1(self.conv1(x))


class _PatchStem(nn.Module):
    """4x4 space-to-depth to 16 channels, a 1x1 embed, then a k3 mix conv,
    all bias-free (JAX ``_PatchStem``, detector.py:156-188). H and W are
    zero-padded up to a multiple of 4 and the output cropped to
    (H//4, W//4). ``pixel_unshuffle`` orders the 16 channels as
    dy * 4 + dx, JAX's reshape order."""

    def __init__(self, features: int = 128):
        super().__init__()
        self.embed = nn.Conv2d(16, features, 1, bias=False)
        self.mix = nn.Conv2d(features, features, 3, padding=1, bias=False)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (-w) % 4, 0, (-h) % 4))
        x = self.mix(self.embed(F.pixel_unshuffle(x, 4)))
        return x[..., : h // 4, : w // 4]


class TomoPickNetW(_Detector):
    """``unetw_N``: patchify stem, ``width``-wide trunk and head input,
    output stride 4 (JAX ``TomoPickNetW``, detector.py:191-268)."""

    stem_stride = 4  # output stride; read by infer/tiled for xy geometry
    # Peak device bytes per input voxel of the fused window batch (f32),
    # read by infer/tiled's memory envelope as JAX reads its own model's
    # (cet_pick_tpu/infer/tiled.py:117-118). chip_smoke.py measured 551.5
    # for unetw_3 over the 4x70 slices of 512x512 it fuses (H100 80GB HBM3):
    # its tensors peak at 17.6 GB (239 B/voxel), and cuDNN takes 27.6 GB
    # more as workspace for each 128-channel 3x3 conv at full resolution
    # when that much is free (PyTorch falls back to leaner algorithms when
    # it is not). Rounded up to 560 and not further: at 576 that batch
    # (42.3 GB) would exceed half of an idle 80 GB card (42.1 GB) and tile
    # xy into nine halo-dominated windows.
    bytes_per_voxel = 560.0

    def __init__(self, heads: Dict[str, int], n_blocks: int = 3,
                 head_conv: int = 128, width: int = 128):
        super().__init__()
        self.n_blocks = n_blocks
        self.stem = _PatchStem(width)
        self.stem_bn = BatchNorm2d(width)
        self.unet = UNet2D(n_blocks, start_filts=width, out_channels=width,
                           in_channels=width)
        self.feature_head = FeatureHead3D(width, head_conv)
        self._add_heads(heads, head_conv)
        flax_init_(self)

    def _stem(self, x):
        return self.stem_bn(self.stem(x))


def create_detector(config) -> _Detector:
    """Build the detector of a Config, mirroring the arch parsing of
    reference models/model.py:65-70 and JAX detector.py:337-373: 'unet_N'
    -> TomoPickNet(n_blocks=N), 'unetw_N' -> TomoPickNetW(n_blocks=N, 3
    without a suffix), 'res3dref_N' -> TomoRes3DRefNet, 'res3d_N' and
    'p3d_N' -> TomoPickNet3D(n_blocks=N, 4 without a suffix)."""
    arch = config.arch
    if config.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {config.dtype}: the port runs float32 only so far")
    if arch.startswith("res3dref"):
        from cet_pick_tpu_torch.models.detector3d_ref import TomoRes3DRefNet

        return TomoRes3DRefNet(heads=dict(config.heads))
    if arch.startswith(("res3d", "p3d")):
        from cet_pick_tpu_torch.models.detector3d import TomoPickNet3D

        return TomoPickNet3D(
            heads=dict(config.heads),
            n_blocks=int(arch.split("_")[1]) if "_" in arch else 4,
            head_conv=config.head_conv)
    if not arch.startswith("unet"):
        raise ValueError(f"unknown detector arch {arch!r}")
    n_blocks = int(arch.split("_")[1]) if "_" in arch else None
    if arch.startswith("unetw"):
        return TomoPickNetW(heads=dict(config.heads), n_blocks=n_blocks or 3,
                            head_conv=config.head_conv)
    return TomoPickNet(heads=dict(config.heads), n_blocks=n_blocks or 4,
                       head_conv=config.head_conv)
