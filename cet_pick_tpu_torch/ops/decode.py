"""Heatmap -> particle coordinates: NMS, top-K, unravel — port of
``cet_pick_tpu/ops/decode.py``.

Reference cet_pick/models/decode.py:82-155. Heatmaps are (D, H, W);
detections are rows of (x, y, z, score, score) like the reference's
``tomo_decode`` output (decode.py:141-155). Everything stays on the
heatmap's device; only the (K, 5) table needs to leave it. The semiclass
decode (``tomo_decode_classify``) is greedy ball NMS on the host, as in
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cet_pick_tpu_torch.ops.greedy_nms import greedy_nms_3d
from cet_pick_tpu_torch.ops.nms import (
    nms3d,
    nms3d_xy,
    nms3d_z,
    sigmoid_clamped,
)


def unravel_3d(inds, h, w):
    """Flat index -> (z, y, x) for a (D, H, W) volume (decode.py:35-41)."""
    z = inds // (h * w)
    t = inds - z * (h * w)
    y = t // w
    x = t % w
    return z, y, x


def topk_3d(scores, k=900):
    """Top-K over a (D, H, W) volume -> (scores, z, y, x, flat_inds)
    (decode.py:82-92).

    One flat ``torch.topk``. The JAX package's blocked top-k
    (decode.py:48-62) works around a slow flat top-k on the v5e; it selects
    the same row set. The order among tied scores is unspecified in both,
    as in the reference."""
    d, h, w = scores.shape
    top_scores, top_inds = torch.topk(scores.reshape(-1), k)
    z, y, x = unravel_3d(top_inds, h, w)
    return top_scores, z, y, x, top_inds


def tomo_decode(heat, kernel=3, k=900, if_fiber=False):
    """NMS + top-K decode of a post-sigmoid heatmap (decode.py:123-155).

    heat: (D, H, W) probabilities. Returns (k, 5) float32 rows
    (x + 0.25, y + 0.25, z, score, score). Fiber mode applies separable
    xy-then-z NMS (decode.py:126-128).
    """
    if if_fiber:
        heat = nms3d_xy(heat, kernel=kernel)
        heat = nms3d_z(heat, kernel=kernel)
    else:
        heat = nms3d(heat, kernel=kernel)
    scores, z, y, x, _ = topk_3d(heat, k=k)
    s = scores.float()
    return torch.stack([x.float() + 0.25, y.float() + 0.25, z.float(), s, s],
                       dim=1)


def tomo_decode_classify(heat, r, threshold):
    """Greedy spherical-NMS decode for the semiclass task
    (decode.py:99-115, reference decode.py:108-120): host-side suppression
    of a (D, H, W) probability volume with exclusion diameter r, keeping
    scores above threshold. Returns (N, 4) float32 rows (x, y, z, score)."""
    scores, coords = greedy_nms_3d(np.asarray(heat), r, threshold=threshold)
    if len(scores) == 0:
        return np.zeros((0, 4), dtype=np.float32)
    return np.concatenate(
        [coords.astype(np.float32), scores[:, None].astype(np.float32)],
        axis=1)


def decode_detections(hm_logits, kernel=3, k=900, if_fiber=False):
    """Clamped sigmoid + NMS + top-K from raw heatmap logits
    (decode.py:118-121): the (k, 5) table of ``tomo_decode``."""
    return tomo_decode(sigmoid_clamped(hm_logits), kernel=kernel, k=k,
                       if_fiber=if_fiber)
