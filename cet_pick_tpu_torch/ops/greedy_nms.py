"""Greedy spherical non-maximum suppression (host-side) — a copy of
``cet_pick_tpu/ops/greedy_nms.py``, numpy on the host as in JAX.

Re-implements reference cet_pick/models/decode.py:42-79
(``non_maximum_suppression_3d``): visit voxels in descending score order,
emit each unsuppressed voxel as a center and suppress every voxel within a
ball of radius ``scale * d / 2`` around it. The reference suppresses by
flat-index deltas, which wrap around the x/y edges; this suppresses in true
3D coordinates, clipped at the borders, as JAX does. Only voxels above
``threshold`` are visited, in a Python loop over those candidates.
"""

from __future__ import annotations

import numpy as np


def _ball_offsets(r):
    width = int(np.ceil(r))
    a = np.arange(-width, width + 1)
    ii, jj, kk = np.meshgrid(a, a, a, indexing="ij")
    mask = (ii ** 2 + jj ** 2 + kk ** 2) <= r * r
    return ii[mask], jj[mask], kk[mask]


def greedy_nms_3d(x, d, scale=1.0, threshold=-np.inf):
    """Greedy ball suppression over a (D, H, W) score volume.

    Returns (scores, coords) where coords rows are (x, y, z) — i.e. reversed
    volume axes, matching the reference's output convention (decode.py:69-73).
    """
    x = np.asarray(x)
    r = scale * d / 2.0
    dz, dy, dx = _ball_offsets(r)

    depth, height, width = x.shape
    if np.isneginf(threshold):
        cand = np.argwhere(np.isfinite(x))
    else:
        cand = np.argwhere(x > threshold)
    if cand.size == 0:
        return np.zeros(0, dtype=np.float32), np.zeros((0, 3), dtype=np.int32)
    vals = x[cand[:, 0], cand[:, 1], cand[:, 2]]
    order = np.argsort(-vals, kind="stable")
    cand = cand[order]
    vals = vals[order]

    suppressed = np.zeros(x.shape, dtype=bool)
    out_scores = []
    out_coords = []
    for (zz, yy, xx), v in zip(cand, vals):
        if suppressed[zz, yy, xx]:
            continue
        out_scores.append(v)
        out_coords.append((xx, yy, zz))
        sz = np.clip(zz + dz, 0, depth - 1)
        sy = np.clip(yy + dy, 0, height - 1)
        sx = np.clip(xx + dx, 0, width - 1)
        suppressed[sz, sy, sx] = True

    return (
        np.asarray(out_scores, dtype=np.float32),
        np.asarray(out_coords, dtype=np.int32),
    )
