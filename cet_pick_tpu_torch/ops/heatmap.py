"""Gaussian heatmap target construction (host-side numpy) — a copy of
``cet_pick_tpu/ops/heatmap.py:26-188``, so that targets are byte-identical.

CenterNet-style target splatting of reference cet_pick/utils/image.py:538-597:

* ``gaussian_radius``      — image.py:538-558 (CornerNet radius from bbox size)
* ``gaussian3d``           — image.py:571-577 (plateau: values > 0.9 snapped to 1)
* ``gaussian3d_discrete``  — image.py:560-569 (binary labels via threshold)
* ``draw_gaussian_3d``     — image.py:579-597 (max-splat at a center, clipped)
* ``build_heatmap``        — tomo_moco.py:91-130 (full-volume target from all
                             annotations, with the PU convention of marking
                             unlabeled voxels -1: tomo_moco.py:122-124)

Targets are built once per tomogram when the dataset is built; the train
step crops windows out of them.
"""

from __future__ import annotations

import math

import numpy as np


def gaussian_radius(det_size, min_overlap=0.7):
    """CornerNet gaussian radius for a (h, w) box at given min IoU overlap."""
    height, width = det_size

    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def gaussian3d(shape, sigma=1):
    """Isotropic 3D gaussian with tiny values zeroed and a >0.9 plateau -> 1."""
    m, n, o = [(ss - 1.0) / 2.0 for ss in shape]
    y, x, z = np.ogrid[-m : m + 1, -n : n + 1, -o : o + 1]
    h = np.exp(-(x * x + y * y + z * z) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    h[h > 0.9] = 1
    return h


def gaussian3d_discrete(shape, sigma=1, label1=1, label2=2, thresh=0.5):
    """Thresholded gaussian: >= thresh -> label1, else label2."""
    m, n, o = [(ss - 1.0) / 2.0 for ss in shape]
    y, x, z = np.ogrid[-m : m + 1, -n : n + 1, -o : o + 1]
    h = np.exp(-(x * x + y * y + z * z) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    out = np.where(h >= thresh, float(label1), float(label2))
    return out


def draw_gaussian_3d(
    heatmap, center, radius, label1=0, label2=0, thresh=0.0, k=1, discrete=False
):
    """Max-splat a radius-r gaussian centered at (x, y, z) into ``heatmap`` (z, y, x order).

    ``heatmap`` has shape (D, H, W); ``center`` is (x, y, z). The gaussian is
    clipped at the volume borders (image.py:588-595). Modifies in place and
    returns the heatmap.
    """
    diameter = 2 * radius + 1
    if discrete:
        gaussian = gaussian3d_discrete(
            (diameter, diameter, diameter),
            sigma=diameter / 6,
            label1=label1,
            label2=label2,
            thresh=thresh,
        )
    else:
        gaussian = gaussian3d((diameter, diameter, diameter), sigma=diameter / 6)
    x, y, z = int(center[0]), int(center[1]), int(center[2])
    depth, height, width = heatmap.shape[:3]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    front, back = min(z, radius), min(depth - z, radius + 1)

    masked_heatmap = heatmap[z - front : z + back, y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[
        radius - front : radius + back,
        radius - top : radius + bottom,
        radius - left : radius + right,
    ]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def downscale_coord(ann, down_ratio=2, compress=False):
    """Annotation (x, y, z) -> heatmap grid coords (tomo_moco.py:57-62)."""
    x = ann[0] // down_ratio
    y = ann[1] // down_ratio
    z = ann[2] // 2 if compress else ann[2]
    return [int(x), int(y), int(z)]


def build_heatmap(
    tomo_shape,
    coords,
    bbox=32,
    down_ratio=2,
    compress=False,
    fiber=False,
    pu=True,
    train=True,
):
    """Full-volume gaussian target + bookkeeping for one tomogram.

    Mirrors TOMOMoco.load_data's per-tomogram loop (tomo_moco.py:91-130):
    output heatmap shape (D, H//down_ratio, W//down_ratio); each annotation is
    splatted with the CornerNet radius of the down-scaled bbox; fiber mode uses
    discrete {1, 0} labels at threshold 0.2; in PU mode (train, not pn)
    untouched voxels are set to -1.

    Returns (hm, inds, gt_det, anns_down):
      hm:       (D, H', W') float32 target
      inds:     (n,) flat z*(H'*W') + y*W' + x indices
      gt_det:   (n, 3) downscaled float32 coords (or (1,3) zeros when empty)
      anns_down:(n, 3) downscaled int coords
    """
    depth, height, width = tomo_shape
    output_h, output_w = height // down_ratio, width // down_ratio
    hm = np.zeros((depth, output_h, output_w), dtype=np.float32)

    n = len(coords)
    inds = np.zeros((n,), dtype=np.int64)
    gt_det = []
    anns_down = []
    h = bbox // down_ratio
    radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(h)))))
    n_oob = 0
    for k in range(n):
        ann = downscale_coord(coords[k], down_ratio=down_ratio, compress=compress)
        ct = np.asarray(ann, dtype=np.int32)
        if not (0 <= ct[0] < output_w and 0 <= ct[1] < output_h
                and 0 <= ct[2] < depth):
            n_oob += 1
            continue
        if fiber:
            draw_gaussian_3d(hm, ct, radius, 1, 0, 0.2, discrete=True)
        else:
            draw_gaussian_3d(hm, ct, radius, discrete=False)
        inds[len(anns_down)] = (
            ct[2] * (output_w * output_h) + ct[1] * output_w + ct[0]
        )
        gt_det.append(ann)
        anns_down.append(ann)
    if n_oob:
        import warnings

        warnings.warn(
            f"build_heatmap: dropped {n_oob}/{n} annotations outside the "
            f"volume (shape {tomo_shape}) — check the --order axis convention "
            f"and coordinate files",
            stacklevel=2,
        )
    if n and n_oob == n:
        raise ValueError(
            f"all {n} annotations fall outside the volume (shape {tomo_shape});"
            " the --order axis convention or the coordinate order is wrong"
        )
    inds = inds[: n - n_oob]
    gt_det = (
        np.array(gt_det, dtype=np.float32) if gt_det else np.zeros((1, 3), dtype=np.float32)
    )
    anns_down = np.array(anns_down, dtype=np.int32).reshape(-1, 3)
    if train and pu:
        hm[hm == 0] = -1
    return hm, inds, gt_det, anns_down
