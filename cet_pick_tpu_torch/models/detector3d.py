"""TomoPickNet3D (``res3d_N``, ``p3d_N``) — the fully-3D residual detector
of the semi3d task, port of ``cet_pick_tpu/models/detector3d.py``.

The JAX package's counterpart of the reference's 3D arches (``res3d``
models/networks/resnet_3d_small.py, ``p3d`` p3d_small.py): the contract of
TomoPickNet ((B, D, H, W) in, {head: (B, D, H/2, W/2, C)} out, down_ratio 2
in xy only), with 3D convolutions throughout:

    stem    Conv3d 1->16 k(3,7,7) stride (1,2,2) SAME, GroupNorm(8), ReLU
    blocks  N x ResBlock3D(32): conv k3, GN, ReLU, conv k3, GN, + residual
            (a 1x1x1 projection where the width changes), ReLU
    context two k3 dilation-(1,4,4) SAME convs, no bias, each + ReLU
    heads   Conv3d k(3,1,1), no bias; 'proj' L2-normalized

The trunk runs NCDHW. The context stage is exactly the z-tap conv with
ReLU, so it is the port's ``FeatureHead3D`` (children ``0`` and ``2``):
in eval mode on the card each layer is one launch of the z-tap kernel, in
train mode the plain z-tap form with autograd. JAX runs XLA convolutions
there; the function is the same.

flax's SAME padding of a strided conv is asymmetric: k7 stride 2 over an
even extent pads (2, 3), not (3, 3), so the stem pads explicitly. flax's
GroupNorm epsilon is 1e-6 (torch's default is 1e-5).

Under ``--dtype bfloat16`` (``dtype``) the layers run in bf16 with flax's
rounding points, as ``models/detector.py`` says; GroupNorm takes its
statistics and arithmetic in float32 and rounds its output (``group_norm``).
JAX's context convs are direct bf16 convs, rounded once per output; the
z-tap form rounds each z offset's plane and then each add, at most a bf16
ulp or two apart (ROADMAP Queue 3).

GroupNorm takes its statistics over a sample's whole extent, so these
detectors run untiled (``untiled``; infer/tiled.py raises when a volume
cannot fit rather than tiling it).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from cet_pick_tpu_torch.models.detector import FeatureHead3D, _Detector
from cet_pick_tpu_torch.models.flax_init import flax_init_
from cet_pick_tpu_torch.models.unet import run_conv

GN_EPS = 1e-6  # flax nn.GroupNorm's default


def group_norm(gn: nn.GroupNorm, x):
    """``gn`` at x's dtype, as flax's ``GroupNorm(dtype=...)``: a bfloat16
    x is normalized in float32 and the output rounded to bf16."""
    if x.dtype != torch.bfloat16:
        return gn(x)
    return F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias,
                        gn.eps).to(x.dtype)


def same_pad(size: int, kernel: int, stride: int):
    """flax/XLA SAME padding (before, after) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ResBlock3D(nn.Module):
    """conv k3 -> GN -> ReLU -> conv k3 -> GN, + residual, ReLU
    (detector3d.py:24-44); stride 1, so SAME is padding 1."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv3d(in_features, features, 3, padding=1,
                               bias=False)
        self.gn1 = nn.GroupNorm(8, features, eps=GN_EPS)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1, bias=False)
        self.gn2 = nn.GroupNorm(8, features, eps=GN_EPS)
        self.proj = (nn.Conv3d(in_features, features, 1, bias=False)
                     if in_features != features else None)

    def forward(self, x):
        y = F.relu(group_norm(self.gn1, run_conv(self.conv1, x)))
        y = group_norm(self.gn2, run_conv(self.conv2, y))
        residual = x if self.proj is None else run_conv(self.proj, x)
        return F.relu(y + residual)


class TomoPickNet3D(_Detector):
    """3D residual trunk + dilated context + per-task heads; xy down_ratio
    2, z preserved (detector3d.py:47-86)."""

    stem_stride = 2  # xy output stride; read by infer/tiled
    untiled = True   # GroupNorm statistics span the whole volume
    # Peak device bytes per input voxel of an untiled forward, read by the
    # memory envelope of infer/tiled to refuse a volume that cannot fit:
    # chip_smoke.py measured 150.0 for res3d_2 over a 256x512x512 volume
    # (H100 80GB HBM3, 700 W), rounded up.
    bytes_per_voxel = 160.0

    # The same under bfloat16 (``infer/tiled.bytes_per_voxel``):
    # chip_smoke.py measured 117.0 for res3d_2 (its ``bf16_models`` phase,
    # H100 80GB HBM3, 700 W), rounded up.
    bytes_per_voxel_bf16 = 130.0

    def __init__(self, heads: Dict[str, int], n_blocks: int = 2,
                 head_conv: int = 32, stem_features: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = n_blocks
        self.stem = nn.Conv3d(1, stem_features, (3, 7, 7), stride=(1, 2, 2),
                              bias=False)
        self.stem_gn = nn.GroupNorm(8, stem_features, eps=GN_EPS)
        blocks, width = [], stem_features
        for _ in range(n_blocks):
            blocks.append(ResBlock3D(width, 32))
            width = 32
        self.blocks = nn.ModuleList(blocks)
        self.context = FeatureHead3D(32, head_conv)
        self._add_heads(heads, head_conv)
        flax_init_(self)

    def forward(self, x, active_heads=None):
        """x: (B, D, H, W) -> {head: (B, D, H', W', C)}."""
        _, _, h, w = x.shape
        ph, pw = same_pad(h, 7, 2), same_pad(w, 7, 2)
        x = x[:, None]
        if self.dtype == torch.bfloat16:
            x = x.to(self.dtype)
        x = F.pad(x, (*pw, *ph, 1, 1))
        x = F.relu(group_norm(self.stem_gn, run_conv(self.stem, x)))
        for block in self.blocks:
            x = block(x)
        x = self.context(x.permute(0, 2, 3, 4, 1).contiguous())
        return self._apply_heads(x, active_heads)
