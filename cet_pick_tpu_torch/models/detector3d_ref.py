"""TomoRes3DRefNet (``res3dref_N``) — the reference-structural 3D detector,
port of ``cet_pick_tpu/models/detector3d_ref.py``.

A layer-for-layer mirror of the reference's ``TomoRes3DNet``
(cet_pick/models/networks/resnet_3d_small.py:140-341), with the
reference's module names, so that a reference ``semi3d`` checkpoint loads
with ``strict=True`` (the names ``convert.py:621-656`` maps):

* conv1: 1->64 k7 stride 2 padding 3, no bias       (:148-154)
* maxpool k3 stride 2 padding 1                     (:158)
* layer1: 2 x BasicBlock(64): conv3x3x3 + ReLU, conv3x3x3, + residual, ReLU,
  norm-free (:68-97)
* layer2: 2 x BasicBlock(128), the first with stride 2 and a 1x1x1
  ``downsample.0`` conv                              (:160-161)
* deconv_layers: 2 x [conv k3 p1 -> ReLU -> ConvTranspose3d k4 s2 p1 ->
  ReLU] at 64 then 32 channels, no bias              (:162-166, :231-268)
* feature_head: conv 32->16 k3 p1 with bias + ReLU  (:168-170)
* heads: conv 16->classes k1 with bias; 'hm' bias initialized to -2.19;
  'proj' L2-normalized                               (:175-196, :285-293)

The output stride is 2 on every axis, z included, so the detector reports
z_ratio 2 (infer/detector.py). ``ConvTranspose3d(k4, s2, p1)`` is JAX's
VALID transpose conv cropped by 1 on each side, with the kernel flipped on
every spatial axis (``models/convert.state_dict_from_jax``). Every
padding is explicit, as in JAX and the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from cet_pick_tpu_torch.models.conv3d import Conv3d
from cet_pick_tpu_torch.models.flax_init import flax_init_


class RefBasicBlock3D(nn.Module):
    """Norm-free 3D basic block (resnet_3d_small.py:68-97)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(in_planes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=1, bias=False)
        self.downsample = (
            nn.Sequential(nn.Conv3d(in_planes, planes, 1, stride=stride,
                                    bias=False))
            if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class TomoRes3DRefNet(nn.Module):
    """(B, D, H, W) in, {head: (B, D/2, H/2, W/2, C)} out
    (detector3d_ref.py:68-124)."""

    stem_stride = 2  # xy output stride; read by infer/tiled
    z_ratio = 2      # z output stride
    untiled = True   # run whole-volume, as the reference's semi3d does
    # Peak device bytes per input voxel of an untiled forward, read by the
    # memory envelope of infer/tiled to refuse a volume that cannot fit:
    # chip_smoke.py measured 70.2 over a 256x512x512 volume (H100 80GB
    # HBM3, 700 W), rounded up.
    bytes_per_voxel = 80.0

    def __init__(self, heads: Dict[str, int]):
        super().__init__()
        self.heads = dict(heads)
        # oneDNN off on the CPU: its weight gradient of this stem is wrong
        # on 6-slice input (models/conv3d.py)
        self.conv1 = Conv3d(1, 64, 7, stride=2, padding=3, bias=False)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)
        self.layer1 = nn.Sequential(RefBasicBlock3D(64, 64),
                                    RefBasicBlock3D(64, 64))
        self.layer2 = nn.Sequential(RefBasicBlock3D(64, 128, stride=2),
                                    RefBasicBlock3D(128, 128))
        layers = []
        in_planes = 128
        for planes in (64, 32):
            layers += [nn.Conv3d(in_planes, planes, 3, padding=1, bias=False),
                       nn.ReLU(inplace=True),
                       nn.ConvTranspose3d(planes, planes, 4, stride=2,
                                          padding=1, bias=False),
                       nn.ReLU(inplace=True)]
            in_planes = planes
        self.deconv_layers = nn.Sequential(*layers)
        self.feature_head = nn.Sequential(nn.Conv3d(32, 16, 3, padding=1),
                                          nn.ReLU(inplace=True))
        for head, classes in self.heads.items():
            self.add_module(head, nn.Conv3d(16, classes, 1))
        flax_init_(self)
        with torch.no_grad():
            for head in self.heads:
                if "hm" in head:
                    self._modules[head].bias.fill_(-2.19)

    def forward(self, x, active_heads=None):
        """x: (B, D, H, W) -> {head: (B, D/2, H/2, W/2, C)}."""
        x = self.maxpool(F.relu(self.conv1(x[:, None])))
        x = self.deconv_layers(self.layer2(self.layer1(x)))
        x = self.feature_head(x)
        out = {}
        for head in self.heads:
            if active_heads is not None and head not in active_heads:
                continue
            y = self._modules[head](x).permute(0, 2, 3, 4, 1)
            if "proj" in head:
                y = y / torch.linalg.vector_norm(
                    y, dim=-1, keepdim=True).clamp_min(1e-12)
            out[head] = y
        return out
