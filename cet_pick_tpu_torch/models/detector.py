"""TomoPickNet — the refinement heatmap detector, port of
``cet_pick_tpu/models/detector.py`` (``unet_N`` only).

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

Layout: the trunk runs NCHW with z folded into the batch; the head works
channels-last, which is what the z-tap kernel takes. The public
``TomoPickNet.forward`` keeps the JAX layout: input ``(B, D, H, W)``,
output ``{head: (B, D, H//2, W//2, C)}``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

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
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # Conv3d's init

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


class TomoPickNet(nn.Module):
    """Slice-wise 2D UNet + dilated 3D head heatmap detector."""

    stem_stride = 2  # output stride; read by infer/tiled for xy geometry

    def __init__(self, heads: Dict[str, int], n_blocks: int = 4,
                 head_conv: int = 32, stem_features: int = 16):
        super().__init__()
        self.heads = dict(heads)
        self.n_blocks = n_blocks
        self.conv1 = _Stem(stem_features)
        self.bn1 = BatchNorm2d(stem_features)
        self.unet = UNet2D(n_blocks, start_filts=32, out_channels=32,
                           in_channels=stem_features)
        self.feature_head = FeatureHead3D(32, head_conv)
        for head, classes in self.heads.items():
            self.add_module(head, nn.Conv3d(head_conv, classes, (3, 1, 1),
                                            padding=(1, 0, 0), bias=False))

    def forward(self, x, active_heads=None):
        """x: (B, D, H, W) -> {head: (B, D, H', W', C)}.

        active_heads: optional subset of the heads to compute (whole-volume
        picking needs only 'hm')."""
        b, d, h, w = x.shape
        x = x.reshape(b * d, 1, h, w)
        x = F.relu(self.bn1(self.conv1(x)), inplace=True)
        x = self.unet(x)
        hh, ww = x.shape[-2:]
        # (B*D, 32, H', W') -> channels-last (B, D, H', W', 32) for the head
        x = x.permute(0, 2, 3, 1).contiguous().reshape(b, d, hh, ww, -1)
        x = self.feature_head(x)
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


def create_detector(config) -> TomoPickNet:
    """Build a TomoPickNet from a Config (arch 'unet_N' -> n_blocks=N),
    mirroring the arch parsing of reference models/model.py:65-70."""
    arch = config.arch
    if config.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {config.dtype}: the port runs float32 only so far")
    if arch.startswith("unetw") or arch.startswith(("res3d", "p3d")):
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item 7); the "
            f"port runs unet_N")
    if not arch.startswith("unet"):
        raise ValueError(f"unknown detector arch {arch!r}")
    n_blocks = int(arch.split("_")[1]) if "_" in arch else 4
    return TomoPickNet(heads=dict(config.heads), n_blocks=n_blocks,
                       head_conv=config.head_conv)
