"""3D max-pool non-maximum suppression + clamped sigmoid — port of
``cet_pick_tpu/ops/nms.py:21-65``.

Equivalents of reference cet_pick/models/decode.py:11-33 (torch
``max_pool3d`` keep-mask NMS) and cet_pick/models/utils.py:167-169
(``_sigmoid`` clamp). All functions take a single unbatched volume
(D, H, W) on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_clamped(x, eps=1e-4):
    """sigmoid clamped to [eps, 1-eps] (models/utils.py:167-169)."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def _maxpool_same(heat, window):
    """Max pool with stride 1 and SAME extent (odd windows); max pooling
    pads with -inf."""
    pads = tuple(w // 2 for w in window)
    return F.max_pool3d(heat[None, None], window, stride=1,
                        padding=pads)[0, 0]


def nms3d(heat, kernel=3, kernel_z=3):
    """Full 3D NMS: keep voxels equal to their (kz, k, k) window max
    (decode.py:27-33). The reference fixes the z window to 3 whatever
    ``kernel`` is (decode.py:30-31)."""
    hmax = _maxpool_same(heat, (kernel_z, kernel, kernel))
    return heat * (hmax == heat).to(heat.dtype)


def nms3d_xy(heat, kernel=3):
    """Separable xy-only NMS (decode.py:11-17), used for fibers."""
    hmax = _maxpool_same(heat, (1, kernel, kernel))
    return heat * (hmax == heat).to(heat.dtype)


def nms3d_z(heat, kernel=3):
    """Separable z-only NMS (decode.py:19-25)."""
    hmax = _maxpool_same(heat, (kernel, 1, 1))
    return heat * (hmax == heat).to(heat.dtype)
