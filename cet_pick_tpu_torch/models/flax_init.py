"""flax's default initializers for the port's models.

The JAX package builds every model with flax's defaults: ``nn.Conv``,
``nn.ConvTranspose`` and ``nn.Dense`` draw their kernels from
``lecun_normal`` (a normal of variance 1 / fan_in, cut at two standard
deviations) and start their biases at zero; the norms start at scale one
and bias zero, as torch's do. torch's convolutions and linear layers draw
from kaiming-uniform with a = sqrt(5), a third of that variance, and draw
their biases too. The starting point decides how fast a short run learns,
so the port's models start from flax's distributions. The draws are
torch's and cannot equal JAX's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of N(0, 1) cut at +-2; flax divides by it so the
# cut draws keep the variance asked for (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def flax_init_(model: nn.Module) -> nn.Module:
    """Re-draw every kernel of ``model`` (each module's ``weight`` of two or
    more axes) from ``lecun_normal`` and zero its bias. flax's fan-in is the
    kernel's size without its output axis: ``weight[0].numel()`` in torch's
    (out, in, *k) layout, and ``in * prod(k)`` for a transposed conv, whose
    torch layout is (in, out, *k)."""
    for m in model.modules():
        w = m._parameters.get("weight")
        if w is None or w.ndim < 2:
            continue
        if isinstance(m, nn.modules.conv._ConvTransposeNd):
            fan_in = w.shape[0] * w[0, 0].numel()
        else:
            fan_in = w[0].numel()
        lecun_normal_(w, fan_in)
        if m._parameters.get("bias") is not None:
            nn.init.zeros_(m.bias)
    return model
