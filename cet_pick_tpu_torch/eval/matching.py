"""Hungarian coordinate matching — a copy of ``cet_pick_tpu/eval/matching.py``
(reference cet_pick/evaluation/algorithms.py:6-21).

Predictions are optimally assigned to targets by the Hungarian algorithm
(scipy ``linear_sum_assignment``) on a cost of squared distance offset by
radius^3 (the reference's exact cost — the cube, not the square: cost =
d^2 - r^3, clipped at 0). A prediction counts as a hit only if its assigned
pair has negative cost.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def match_coordinates(targets: np.ndarray, preds: np.ndarray, radius: float):
    """Return (assignment, dist): per-prediction hit flags and distances.

    targets: (T, 3), preds: (P, 3). assignment[i] = 1 if prediction i was
    assigned a target within the radius cost; dist[i] = distance to its
    assigned target (0 if unassigned).
    """
    targets = np.asarray(targets, dtype=np.float64)
    preds = np.asarray(preds, dtype=np.float64)
    if len(preds) == 0:
        return np.zeros(0, dtype=np.float32), np.zeros(0)
    if len(targets) == 0:
        return np.zeros(len(preds), dtype=np.float32), np.zeros(len(preds))

    d2 = np.sum((preds[:, np.newaxis] - targets[np.newaxis]) ** 2, 2)
    cost = d2 - radius * radius * radius
    cost[cost > 0] = 0

    pred_index, target_index = linear_sum_assignment(cost)
    assigned_cost = cost[pred_index, target_index]
    dist = np.zeros(len(preds))
    dist[pred_index] = np.sqrt(d2[pred_index, target_index])

    hit_index = pred_index[assigned_cost < 0]
    assignment = np.zeros(len(preds), dtype=np.float32)
    assignment[hit_index] = 1
    return assignment, dist
