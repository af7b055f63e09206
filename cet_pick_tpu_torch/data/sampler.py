"""Stratified positive/negative voxel samplers — a copy of
``cet_pick_tpu/data/sampler.py``, numpy only, whose draws keep JAX's order
exactly, so that one ``np.random.Generator`` gives the same index stream in
both packages.

Rebuild of reference cet_pick/utils/sampler.py:1-322: balanced streaming
samplers over labeled/unlabeled voxel pools, used by the semiclass task
(data/classify_dataset.py). The reference keeps a running ``history`` of
emitted group counts and corrects sampling weights toward the target
balance; the same debt-correction scheme is used here.
"""

from __future__ import annotations

import numpy as np


class ShuffledSampler:
    """Endless shuffled stream over an index array (sampler.py ShuffledSampler)."""

    def __init__(self, items, random: np.random.Generator = None):
        self.items = np.asarray(items)
        self.random = random or np.random.default_rng()
        self._order = self.random.permutation(len(self.items))
        self._pos = 0

    def __len__(self):
        return len(self.items)

    def __next__(self):
        if self._pos >= len(self._order):
            self._order = self.random.permutation(len(self.items))
            self._pos = 0
        out = self.items[self._order[self._pos]]
        self._pos += 1
        return out


def enumerate_pn_coordinates_hm(labels, thresh=0.5):
    """Flat indices of positive (> thresh) and negative (<= thresh, labeled)
    voxels of a heatmap volume."""
    flat = np.asarray(labels).ravel()
    pos = np.where(flat > thresh)[0]
    neg = np.where((flat <= thresh) & (flat >= 0))[0]
    return pos, neg


def enumerate_pu_coordinates_hm(labels, thresh=0.5):
    """Flat indices of positive (> thresh) and unlabeled-or-other voxels."""
    flat = np.asarray(labels).ravel()
    pos = np.where(flat > thresh)[0]
    unl = np.where(flat <= thresh)[0]
    return pos, unl


class StratifiedCoordinateSampler:
    """Balance-corrected sampler over (positive, negative/unlabeled) pools
    (sampler.py:143-318).

    Yields flat voxel indices; group identity is recoverable by membership.
    ``balance`` is the target positive fraction; a history-debt correction
    keeps the realized mix on target even for short draws.
    """

    def __init__(self, labels, thresh=0.5, balance=0.5, size=None,
                 random: np.random.Generator = None, split="pn"):
        random = random or np.random.default_rng()
        if split == "pn":
            pos, other = enumerate_pn_coordinates_hm(labels, thresh)
        elif split == "pu":
            pos, other = enumerate_pu_coordinates_hm(labels, thresh)
        else:
            raise ValueError(f"unknown split {split!r}")
        if len(pos) == 0 or len(other) == 0:
            raise ValueError("both groups must be non-empty for stratified sampling")
        self.groups = [ShuffledSampler(pos, random), ShuffledSampler(other, random)]
        p = balance if balance is not None else len(pos) / (len(pos) + len(other))
        self.weights = np.array([p, 1 - p], dtype=np.float64)
        self.size = size if size is not None else len(pos) + len(other)
        self.history = np.zeros_like(self.weights)
        self.random = random

    def __len__(self):
        return self.size

    def __next__(self):
        n = self.history.sum()
        weights = self.weights
        if n > 0:
            corrected = weights - self.history / n
            corrected[corrected < 0] = 0
            s = corrected.sum()
            weights = corrected / s if s > 0 else self.weights
        g = int(self.random.random() > weights[0])
        self.history[g] += 1
        if self.history.sum() >= self.size:
            self.history[:] = 0
        return int(next(self.groups[g]))

    def __iter__(self):
        for _ in range(self.size):
            yield next(self)
