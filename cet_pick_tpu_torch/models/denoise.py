"""Blind-spot denoising UNet (SSDN, Laine et al. 2019) — port of
``cet_pick_tpu/models/denoise.py`` in NCHW.

Behavioral equivalent of the reference's ``NoiseNetwork``
(reference: cet_pick/models/networks/denoise_network.py:15-266, task
``denoise``): a 5-level N2N-style UNet with LeakyReLU(0.1) where, in
blindspot mode,

* every conv is a ShiftConv — padded k//2 rows at the top, a SAME conv, and
  the bottom k//2 rows cropped, so the receptive field only extends upward
  (:245-263);
* downsampling shifts one row down before max pooling (:66-69);
* the input batch is replicated under 4 rotations (riding the batch axis),
  and after the encode-decode the rotations are undone and concatenated on
  channels in rotation order before three 1x1 convs (:188-228).

The convs are named as flax names them (``ShiftConv_<i>``, in creation
order; the ``enc`` / ``dec`` / ``head`` lists only hold them), since no
reference ``.pth`` layout exists;
``models/convert.denoise_state_dict_from_jax`` maps JAX's weights onto
them. Every skip concatenates ``[up, skip]``, JAX's order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cet_pick_tpu_torch.models.flax_init import lecun_normal_


def shift_down(x, s=1):
    """Pad s rows at the top, crop s at the bottom. x: (B, C, H, W)."""
    if s == 0:
        return x
    return F.pad(x, (0, 0, s, 0))[..., :-s, :]


class ShiftConv(nn.Conv2d):
    """SAME conv whose receptive field is restricted upward (:33-58):
    flax's ``lecun_normal`` kernel (zeros under ``zero_init``) and a zero
    bias, or ``bias_init``'s per-channel values."""

    def __init__(self, in_channels, features, kernel=3, blindspot=True,
                 zero_init=False, bias_init=()):
        super().__init__(in_channels, features, kernel, padding=kernel // 2)
        self.blindspot = blindspot
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, self.weight[0].numel())
        with torch.no_grad():
            if bias_init:
                self.bias.copy_(torch.tensor(bias_init, dtype=self.bias.dtype))
            else:
                self.bias.zero_()

    def forward(self, x):
        s = self.kernel_size[0] // 2
        if self.blindspot and s > 0:
            return super().forward(F.pad(x, (0, 0, s, 0)))[..., :-s, :]
        return super().forward(x)


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.1)


def _maxpool(x, blindspot):
    if blindspot:
        x = shift_down(x, 1)
    return F.max_pool2d(x, 2)


def _upsample(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class NoiseNetwork(nn.Module):
    """SSDN / N2N UNet (:76-143). Input (B, C, H, W); H and W must be
    multiples of 32 (of 32 and equal, in blindspot mode). The output is
    float32 (B, out_channels, H, W)."""

    def __init__(self, in_channels=1, out_channels=1, blindspot=False,
                 zero_output_weights=False):
        super().__init__()
        self.blindspot = blindspot
        self._n = 0
        bs = blindspot

        def conv(cin, f, k=3):
            return self._add(ShiftConv(cin, f, k, blindspot=bs))

        self.enc = [conv(in_channels, 48), conv(48, 48)] + \
            [conv(48, 48) for _ in range(5)]
        self.dec = [conv(96, 96), conv(96, 96)]
        for _ in range(3):
            self.dec += [conv(96 + 48, 96), conv(96, 96)]
        self.dec += [conv(96 + in_channels, 96), conv(96, 96)]
        nin = 96 * 4 if bs else 96
        # two 1x1 convs, then the SSDN head (out_channels == 2: mu, A with
        # sigma_x = A^2), whose A channel's bias starts at 1, so that
        # sigma_y starts O(1) (:126-136)
        self.head = [conv(nin, nin, 1), conv(nin, 96, 1), self._add(ShiftConv(
            96, out_channels, 1, blindspot=False,
            zero_init=zero_output_weights,
            bias_init=(0.0, 1.0) if out_channels == 2 else ()))]

    def _add(self, module):
        self.add_module(f"ShiftConv_{self._n}", module)
        self._n += 1
        return module

    def forward(self, x):
        bs = self.blindspot
        if bs:
            x = torch.cat([torch.rot90(x, r, dims=(2, 3)) for r in range(4)])
        skip_in = x
        enc = self.enc
        y = _lrelu(enc[1](_lrelu(enc[0](x))))
        pools = [_maxpool(y, bs)]
        for c in enc[2:6]:
            pools.append(_maxpool(_lrelu(c(pools[-1])), bs))
        encoded = _lrelu(enc[6](pools[-1]))        # pools: pool1..pool5

        dec = self.dec
        y = torch.cat([_upsample(encoded), pools[3]], dim=1)
        y = _upsample(_lrelu(dec[1](_lrelu(dec[0](y)))))
        for i, skip in enumerate((pools[2], pools[1], pools[0])):
            y = torch.cat([y, skip], dim=1)
            y = _upsample(_lrelu(dec[3 + 2 * i](_lrelu(dec[2 + 2 * i](y)))))
        y = torch.cat([y, skip_in], dim=1)
        y = _lrelu(dec[9](_lrelu(dec[8](y))))

        if bs:
            y = shift_down(y, 1)
            chunks = torch.chunk(y, 4, dim=0)
            y = torch.cat([torch.rot90(c, (4 - r) % 4, dims=(2, 3))
                           for r, c in enumerate(chunks)], dim=1)
        y = _lrelu(self.head[1](_lrelu(self.head[0](y))))
        return self.head[2](y).float()


def create_denoise_models():
    """{'denoise': blindspot 2-channel net, 'sigma': plain net with zero
    output weights} (:146-155; denoise_network.py:268-276)."""
    return {
        "denoise": NoiseNetwork(out_channels=2, blindspot=True),
        "sigma": NoiseNetwork(out_channels=1, blindspot=False,
                              zero_output_weights=True),
    }
