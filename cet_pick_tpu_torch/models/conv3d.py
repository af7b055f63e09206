"""A 3D convolution that keeps torch's CPU build off oneDNN.

torch 2.13's CPU build returns a wrong weight gradient through oneDNN for
a k7 s2 p3 Conv3d on 6-deep input (``VolTrunkRef``'s stem on the explore
crop, ``TomoRes3DRefNet``'s on a 6-slice volume): 1e30 or NaN against the
same step in float64, while its plain kernel and cuDNN are right. torch
reads the oneDNN flag when the backward runs, not when the forward does,
so a context around the model's call is not enough: the convolution's own
backward turns it off. Only those stems take it: elsewhere oneDNN's f32
gradients are right, and nearer float64 than the plain kernel's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _PlainConv3d(torch.autograd.Function):
    """``F.conv3d`` with its forward and backward run with oneDNN off."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = (bias is not None, stride, padding)
        with torch.backends.mkldnn.flags(enabled=False):
            return F.conv3d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        has_bias, stride, padding = ctx.conv
        with torch.backends.mkldnn.flags(enabled=False):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None,
                stride, padding, (1, 1, 1), False, (0, 0, 0), 1,
                (*ctx.needs_input_grad[:2], has_bias))
        return gx, gw, gb, None, None


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (ungrouped, undilated) that runs with oneDNN off on a
    CPU tensor; on the card it is the stock module."""

    def forward(self, x):
        if x.device.type != "cpu":
            return super().forward(x)
        return _PlainConv3d.apply(x, self.weight, self.bias, self.stride,
                                  self.padding)
