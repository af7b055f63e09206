"""Difference-of-Gaussian candidate mining — port of
``cet_pick_tpu/ops/dog.py:27-106``.

Re-implements reference cet_pick/utils/image.py:138-183
(``get_potential_coords_pyramid``): multi-sigma 3D gaussian blurs,
consecutive differences with zeroed borders, per-scale xy NMS, max across
scales, an adaptive threshold mean + std/2 over positive responses, then
greedy spherical NMS (diameter 14) to emit candidate centres.

``dog_response`` runs on the volume's device (the card in the entry points);
only the sparse greedy suppression runs on the host
(``ops/greedy_nms.greedy_nms_3d``), as in JAX. The blur is separable, one
1D pass per axis with scipy's "reflect" padding, which repeats the edge
sample (numpy's and JAX's ``mode="symmetric"``; torch's ``"reflect"`` does
not repeat it, so the pad is built here by index). Each pass is an explicit
sum of f32 multiply-adds over the taps, so no reduced-precision (TF32)
library path can reach it; JAX pins ``Precision.HIGHEST`` for the same
reason.
"""

from __future__ import annotations

import numpy as np
import torch

from cet_pick_tpu_torch.ops.greedy_nms import greedy_nms_3d
from cet_pick_tpu_torch.ops.nms import nms3d_xy


def _gaussian_kernel1d(sigma):
    """scipy.ndimage-compatible 1D gaussian kernel (radius = 4 sigma + 0.5,
    gaussian_filter's default truncate)."""
    radius = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32), radius


def _symmetric_index(n, radius, device):
    """Source index of each position of a length-``n`` axis padded by
    ``radius`` on both sides with numpy's ``mode="symmetric"`` (the edge
    sample repeated; periodic over 2n when ``radius`` exceeds ``n``)."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _blur_axis(vol, kernel, radius, axis):
    """Symmetric-padded 1D convolution of ``vol`` along ``axis``."""
    n = vol.shape[axis]
    padded = vol.index_select(axis, _symmetric_index(n, radius, vol.device))
    out = torch.zeros_like(vol)
    for t, w in enumerate(kernel.tolist()):
        out.add_(padded.narrow(axis, t, n), alpha=w)
    return out


def gaussian_blur_3d(vol, sigma):
    """Separable 3D gaussian blur matching scipy.ndimage.gaussian_filter
    defaults (dog.py:55-61)."""
    kernel, radius = _gaussian_kernel1d(sigma)
    for axis in range(3):
        vol = _blur_axis(vol, kernel, radius, axis)
    return vol


def dog_response(rec, sigmas=(2, 4), bound_xy=30):
    """DoG pyramid response of a (D, H, W) float32 tensor: blurs, diffs,
    border zeroing (10 z-slices, ``bound_xy`` pixels), 3x3 xy NMS, scale
    max (dog.py:64-89).

    Returns (response, cutoff): the per-voxel NMS'd response volume and the
    adaptive threshold mean + 0.5 * std over positive responses
    (image.py:177-179; std with Bessel's n - 1, as torch ``.std()``).
    """
    d, h, w = rec.shape
    blurred = [gaussian_blur_3d(rec, s) for s in sigmas]
    mask = torch.zeros_like(rec)
    mask[10:d - 10, bound_xy:h - bound_xy, bound_xy:w - bound_xy] = 1.0
    responses = [nms3d_xy((blurred[i + 1] - blurred[i]) * mask)
                 for i in range(len(sigmas) - 1)]
    resp = torch.stack(responses).amax(dim=0)

    pos = resp > 0
    n = pos.sum()
    zero = torch.zeros((), dtype=resp.dtype, device=resp.device)
    mean = torch.where(pos, resp, zero).sum() / n.clamp(min=1)
    var = (torch.where(pos, (resp - mean) ** 2, zero).sum()
           / (n - 1).clamp(min=1))
    return resp, mean + 0.5 * torch.sqrt(var)


def dog_candidates_pyramid(rec, sigmas=(2, 4), device="cuda"):
    """Full candidate mining of a (D, H, W) numpy volume: the response on
    ``device`` (the card unless the caller passes ``device="cpu"``), the
    greedy ball NMS (diameter 14) on the host (dog.py:92-106). Borders of
    10 z-slices and 30 xy-pixels (60 for volumes larger than 512^2) are
    excluded. Returns (scores, coords) with coords rows (x, y, z)."""
    from cet_pick_tpu_torch.infer.detector import resolve_device

    device = resolve_device(device)
    d, h, w = rec.shape
    bound_xy = 60 if (h > 512 and w > 512) else 30
    resp, cutoff = dog_response(
        torch.as_tensor(np.asarray(rec, np.float32), device=device),
        sigmas=tuple(sigmas), bound_xy=bound_xy)
    return greedy_nms_3d(resp.cpu().numpy(), 14, threshold=float(cutoff))
