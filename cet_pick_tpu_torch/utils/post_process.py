"""Host-side detection post-processing: z-grouping, fiber curves, spike
groups — a copy of ``cet_pick_tpu/utils/post_process.py`` (numpy + scipy).

Behavioral rebuild of reference cet_pick/utils/post_process.py:

* ``group_dets_by_z``      — :11-25  (detection table -> {z: rows})
* ``fiber_postprocess``    — :52-106 (distance-graph connected components ->
                              2nd-order polyfits x(y), z(y) with residual and
                              curvature gates -> resampled curve points)
* ``spike_group_postprocess`` — :31-50 (components with > min_per_group kept)

Connected components come from scipy.sparse.csgraph; distances from a
KD-tree instead of the reference's dense O(N^2) pairwise loop (same graph).
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def group_dets_by_z(dets: np.ndarray, z_dim_tot: int):
    """Group a (N, >=4) detection table by integer z (post_process.py:11-25)."""
    out = {}
    z = dets[:, 2]
    for j in range(z_dim_tot):
        rows = dets[z == j]
        if len(rows):
            out[j] = rows.astype(np.float32).tolist()
    return out


def _components(points: np.ndarray, distance_cutoff: float):
    """Labels of connected components of the <=cutoff distance graph."""
    tree = cKDTree(points)
    pairs = tree.query_pairs(distance_cutoff, output_type="ndarray")
    n = len(points)
    if len(pairs) == 0:
        return np.arange(n)
    data = np.ones(len(pairs))
    adj = sparse.coo_matrix(
        (data, (pairs[:, 0], pairs[:, 1])), shape=(n, n)
    )
    _, labels = connected_components(adj, directed=False)
    return labels


def _max_curvature(y, a, b, c):
    """max over y of k(y) = 2a / (1 + (2ay + b)^2)^(2/3) (post_process.py:27-29)."""
    k = (2 * a) / ((1 + (2 * a * y + b) ** 2)) ** (2 / 3)
    return np.max(k)


def spike_group_postprocess(dets_all, distance_cutoff=15.0, min_per_group=5):
    """Keep detections in connected groups larger than min_per_group
    (post_process.py:31-50). dets_all rows: (x, y, z[, score...])."""
    dets_w_score = np.asarray(dets_all, dtype=np.float64)
    if len(dets_w_score) == 0:
        return []
    labels = _components(dets_w_score[:, :3], distance_cutoff)
    out = []
    for lb in np.unique(labels):
        group = dets_w_score[labels == lb]
        if group.shape[0] > min_per_group:
            out.extend(group.tolist())
    return out


def fiber_postprocess(dets, distance_cutoff=15.0, res_cutoff=30.0,
                      curvature_cutoff=0.03, scale=2.0):
    """Fit connected components as 2nd-order curves and resample along them
    (post_process.py:52-106).

    dets rows: (x, y, z). Returns rows (x, z, y) ready for the reference's
    ``x\tz\ty`` output format (tomo_det.py:86-88 prints columns verbatim).
    """
    dets = np.asarray(dets, dtype=np.float64)
    output_coords = []
    if len(dets) == 0:
        return output_coords
    labels = _components(dets, distance_cutoff)
    lines = []
    for lb in np.unique(labels):
        group = dets[labels == lb]
        if group.shape[0] > 6:
            lines.append(group)
    for line in lines:
        cur = line.copy()
        cur[:, [1, 0]] = cur[:, [0, 1]]  # columns -> (y, x, z); fits are f(x)
        span = np.max(cur[:, 1]) - np.min(cur[:, 1])
        num_points = span // 2
        num_points_out = span // scale
        t_range = np.linspace(np.min(cur[:, 1]) - 1, np.max(cur[:, 1]) + 1,
                              int(num_points))
        t_out = np.linspace(np.min(cur[:, 1]) - 1, np.max(cur[:, 1]) + 1,
                            int(num_points_out))
        if t_range.shape[0] == 0:
            continue
        n_fit = cur.shape[0]
        p_tx, res_tx, *_ = np.polyfit(cur[:, 1], cur[:, 0], 2, full=True)
        p_tz, res_tz, *_ = np.polyfit(cur[:, 1], cur[:, 2], 2, full=True)
        res_x = res_tx[0] / n_fit if res_tx.shape[0] > 0 else 10000
        res_z = res_tz[0] / n_fit if res_tz.shape[0] > 0 else 10000
        kx = _max_curvature(t_range, *p_tx)
        kz = _max_curvature(t_range, *p_tz)
        res_total = res_x + res_z
        accept = (
            res_total < res_cutoff
            and abs(kx) < curvature_cutoff and abs(kz) < curvature_cutoff
        ) or (
            res_total < res_cutoff * 3
            and abs(kx) < curvature_cutoff / 10 and abs(kz) < curvature_cutoff / 10
        )
        if accept:
            x_out = np.polyval(p_tx, t_out)
            z_out = np.polyval(p_tz, t_out)
            for j in range(x_out.shape[0]):
                output_coords.append(
                    [int(t_out[j]), int(z_out[j]), int(x_out[j])]
                )
    return output_coords
