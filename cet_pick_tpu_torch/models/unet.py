"""2D U-Net encoder/decoder, the slice-wise backbone of the detector — port
of ``cet_pick_tpu/models/unet.py:23-119``.

The ELEKTRONN3-derived UNet the reference vendors (reference:
cet_pick/models/networks/unet.py:538-884) in the configuration the
production model uses (unet_small.py:38): ``dim=2``, ``merge_mode='concat'``,
``up_mode='transpose'``, SAME 3x3 convs without bias, BatchNorm (eps 1e-5)
then ReLU, start_filts 32, n_blocks down-blocks and n_blocks-1 up-blocks.

Modules keep the reference's attribute names (``down_convs.{i}.conv1``,
``norm0``, ..., ``up_convs.{i}.upconv``, ``conv_final``), so a reference
``TomoConvUNet`` state dict — and the JAX package's export of one — loads
with ``strict=True``. Layout is PyTorch's NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that keeps its running statistics as flax's
    ``nn.BatchNorm(momentum=0.9)`` does (unet.py:37, detector.py:297).

    In train mode it normalizes with the batch statistics, like the stock
    module, but updates ``ra = 0.9 * ra + 0.1 * stat`` with the *biased*
    batch variance; torch's own update uses the unbiased n/(n-1) one. The
    momentum (0.1, torch's convention), eps, parameters and buffers
    (``num_batches_tracked`` included) are the stock module's, so reference
    ``.pth`` files load with ``strict=True``. Eval mode is unchanged."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def ConvNormAct(conv: nn.Conv2d, norm: nn.BatchNorm2d, x):
    """3x3 conv -> BatchNorm -> ReLU (JAX ``ConvNormAct``, unet.py:23-43).

    A function over the block's own conv and norm, so that the state dict
    keeps the reference's flat names (``conv1``/``norm0``, ...)."""
    return F.relu(norm(conv(x)), inplace=True)


def _conv3x3(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class DownBlock(nn.Module):
    """Two ConvNormAct, then 2x max-pool when pooling (unet.py:46-62)."""

    def __init__(self, in_channels: int, features: int, pooling: bool = True):
        super().__init__()
        self.conv1 = _conv3x3(in_channels, features)
        self.norm0 = BatchNorm2d(features)
        self.conv2 = _conv3x3(features, features)
        self.norm1 = BatchNorm2d(features)
        self.pooling = pooling

    def forward(self, x):
        x = ConvNormAct(self.conv1, self.norm0, x)
        x = ConvNormAct(self.conv2, self.norm1, x)
        before_pool = x
        if self.pooling:
            # flax max_pool(2, 2, "SAME") pads odd extents with -inf
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return x, before_pool


class UpBlock(nn.Module):
    """Transpose-conv 2x up -> norm -> ReLU -> concat skip -> two
    ConvNormAct (unet.py:65-91)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(in_channels, features, 2, stride=2)
        self.norm0 = BatchNorm2d(features)
        self.conv1 = _conv3x3(2 * features, features)
        self.norm1 = BatchNorm2d(features)
        self.conv2 = _conv3x3(features, features)
        self.norm2 = BatchNorm2d(features)

    def forward(self, x, skip):
        x = ConvNormAct(self.upconv, self.norm0, x)
        # crop the upsampled map where the encoder extent was odd
        x = x[:, :, : skip.shape[2], : skip.shape[3]]
        x = torch.cat([x, skip], dim=1)
        x = ConvNormAct(self.conv1, self.norm1, x)
        return ConvNormAct(self.conv2, self.norm2, x)


class UNet2D(nn.Module):
    """n_blocks-deep 2D U-Net, start_filts * 2^i channels per level."""

    def __init__(self, n_blocks: int = 4, start_filts: int = 32,
                 out_channels: int = 32, in_channels: int = 16):
        super().__init__()
        self.down_convs = nn.ModuleList(
            DownBlock(in_channels if i == 0 else start_filts * 2 ** (i - 1),
                      start_filts * 2 ** i, pooling=i < n_blocks - 1)
            for i in range(n_blocks)
        )
        self.up_convs = nn.ModuleList(
            UpBlock(start_filts * 2 ** (n_blocks - 1 - i),
                    start_filts * 2 ** (n_blocks - 2 - i))
            for i in range(n_blocks - 1)
        )
        self.conv_final = nn.Conv2d(start_filts, out_channels, 1)

    def forward(self, x):
        skips = []
        for down in self.down_convs:
            x, before = down(x)
            skips.append(before)
        for i, up in enumerate(self.up_convs):
            x = up(x, skips[-(i + 2)])
        return self.conv_final(x)
