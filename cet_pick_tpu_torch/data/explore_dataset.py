"""Exploration (SimSiam / MoCo) datasets: DoG-mined patches from tomograms
(+tilts) or subvolumes — port of ``cet_pick_tpu/data/explore_dataset.py``.

Host numpy as in JAX, apart from the DoG response, which runs on the
dataset's ``device`` (ops/dog.py). The reference's exploration data layer
(reference: cet_pick/datasets/tomo_pre_proj_angle_select_new2d3d.py:25-233
for the 2d3d mode, tomo_pre_proj_angle_select_new3d_vol.py for the 3d-only
mode, and particle_pre_2d_proj_new2d3d.py:70-91 for sampling):

* candidates come from the DoG pyramid miner (ops/dog.py);
* 2d3d mode: for every candidate, (a) a tilt-projection patch — the tomogram
  coordinate is mapped into each tilt image with angle in [low, up] via
  ``tilt_x = (x - cx) cos θ + ((D - z) - cz) sin θ + cx`` and the per-tilt
  crops are summed then min-max normalized (:91-133); (b) a 2D z-slice patch
  from the reconstruction, min-max normalized (:102-111);
* 3d-only mode: just the z-slice patch;
* each kept candidate gets an "aug set": patches at 4 neighboring voxel
  offsets (+z, -z, -x-z, +y-z) (:191-215) — training pairs the anchor with a
  random member;
* dataset-level mean/std of the 2d and 3d patch populations are recorded for
  normalization (:227-230), applied on the device by ops/augment.py;
* vol mode (task ``simsiam``, arches ``simsiam_N`` / ``moco3d_N`` /
  ``*ref_N``): a ``vol_size`` subvolume around every DoG candidate whose
  crop fits the volume (explore_dataset.py:294-330); both training views
  are the same subvolume, told apart by the device pipeline's draws, and
  each subvolume is z-normalized there (no population statistics).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from cet_pick_tpu_torch.ops.dog import dog_candidates_pyramid


def tomo_to_tilt(coord, angle_deg, tomo_size):
    """Map a tomogram (x, y, z) to tilt-image (x, y) at a given angle
    (tomo_pre_proj_angle_select_new2d3d.py:91-96). tomo_size = (X, Y, Z)."""
    a = angle_deg * np.pi / 180.0
    x, y, z = coord[0], coord[1], tomo_size[2] - coord[2]
    tilt_x = (
        (x - tomo_size[0] // 2) * np.cos(a)
        + (z - tomo_size[2] // 2) * np.sin(a)
        + tomo_size[0] // 2
    )
    return int(tilt_x), int(y)


class ExploreDataset:
    """Candidate patches for SimSiam training / embedding extraction.

    mode '2d3d' needs tilt stacks + angles; mode '3d' works from
    reconstructions alone. split 'train' builds aug sets; 'test' keeps one
    patch per candidate (plus its coord + name) for embedding extraction.
    """

    AUG_OFFSETS = ((0, 0, 1), (0, 0, -1), (-1, 0, -1), (0, 1, -1))

    def __init__(self, config, split="train", low=-20.0, up=20.0,
                 images=None, tilts=None, angles=None, device="cuda"):
        from cet_pick_tpu_torch.models.simsiam import explore_mode

        self.config = config
        self.split = split
        # dataset-internal mode names predate the model helper: its '2d'
        # (single z-slice patches) is this class's historical '3d'
        m = explore_mode(config)
        self.mode = "3d" if m == "2d" else m
        self.bbox = int(config.bbox)
        self.vol_size = tuple(int(s) for s in config.vol_size)
        self.low, self.up = low, up
        # where the DoG response runs: the card unless the caller asks for
        # the CPU; checked before any volume is read
        from cet_pick_tpu_torch.infer.detector import resolve_device

        self.device = resolve_device(device)

        if images is None:
            images, tilts, angles = self._load_from_lists()

        sig = config.dog
        self.sigmas = tuple(sig) if np.ndim(sig) else (float(sig), float(sig) * 2)

        self.patches_2d: List[np.ndarray] = []   # anchor tilt (2d3d) patches
        self.patches_3d: List[np.ndarray] = []   # anchor slice patches
        self.aug_sets_2d: List[List[np.ndarray]] = []
        self.aug_sets_3d: List[List[np.ndarray]] = []
        self.subvols: List[np.ndarray] = []      # vol mode: (vz, vy, vx) crops
        self.coords: List[np.ndarray] = []
        self.names: List[str] = []
        for name in images:
            if self.mode == "vol":
                self._mine_tomogram_vol(name, images[name])
            else:
                self._mine_tomogram(
                    name, images[name],
                    tilts.get(name) if tilts else None,
                    angles.get(name) if angles else None,
                )

        if self.mode == "vol":
            # z-normalized per sample on the device (ops/augment.py)
            self.mean_3d, self.std_3d = 0.0, 1.0
            self.mean_2d, self.std_2d = 0.0, 1.0
            self.num_samples = len(self.subvols)
            return

        if self.patches_3d:
            stack3d = np.stack(self.patches_3d)
            self.mean_3d, self.std_3d = float(stack3d.mean()), float(stack3d.std())
        else:
            self.mean_3d = 0.0
            self.std_3d = 1.0
        if self.mode == "2d3d" and self.patches_2d:
            stack2d = np.stack(self.patches_2d)
            self.mean_2d, self.std_2d = float(stack2d.mean()), float(stack2d.std())
        else:
            self.mean_2d, self.std_2d = self.mean_3d, self.std_3d
        self.num_samples = len(self.patches_3d)

    # -- loading -------------------------------------------------------------

    def _load_from_lists(self):
        from cet_pick_tpu_torch.io.coords import read_image_list
        from cet_pick_tpu_torch.io.loader import (
            load_tomo_all_and_angles_from_list,
            load_tomos_from_list,
        )

        cfg = self.config
        txt = cfg.train_img_txt if self.split == "train" else cfg.test_img_txt
        il = read_image_list(os.path.join(cfg.data_dir, txt))
        if self.mode == "2d3d":
            # the tilt and rec axis orders are fixed (zxy, xzy), not --order
            tilts, recs, angles = load_tomo_all_and_angles_from_list(
                il["image_name"], il["tilt_path"], il["rec_path"],
                il["angle_path"], compress=cfg.compress, denoise=cfg.gauss,
            )
            return recs, tilts, {k: v.ravel() for k, v in angles.items()}
        recs = load_tomos_from_list(
            il["image_name"], il["rec_path"],
            order=cfg.order, compress=cfg.compress, denoise=cfg.gauss,
        )
        return recs, None, None

    # -- patch extraction ----------------------------------------------------

    def _slices_batch(self, rec, coords):
        """2D z-slice crops, min-max normalized (extract_3d_tomo, :102-111),
        over (M, 3) int coords (x, y, z_full): one strided fancy-index for
        all windows (explore_dataset.py:185-221).

        Returns (patches (M, b, b) float32, valid (M,) bool), including
        python's negative-z wraparound (rec[-1] = last slice — the
        reference's extract_3d_tomo has the same semantics) and the
        drop-on-truncated-window check."""
        b = self.bbox
        half = b // 2
        d, h, w = rec.shape
        m = coords.shape[0]
        if m == 0 or h < b or w < b:
            return np.zeros((m, b, b), np.float32), np.zeros(m, bool)
        x = coords[:, 0].astype(np.int64)
        y = coords[:, 1].astype(np.int64)
        z = coords[:, 2].astype(np.int64)
        if self.config.compress:
            z = z // 2  # floor division, matching int(z) // 2
        valid = (
            (y - half >= 0) & (y + half <= h)
            & (x - half >= 0) & (x + half <= w)
            & (z >= -d) & (z < d)
        )
        zi = np.where(z < 0, z + d, z)  # python negative indexing
        win = np.lib.stride_tricks.sliding_window_view(rec, (b, b), axis=(1, 2))
        p = win[
            np.clip(zi, 0, d - 1),
            np.clip(y - half, 0, h - b),
            np.clip(x - half, 0, w - b),
        ].astype(np.float32)
        lo = p.min(axis=(1, 2))
        hi = p.max(axis=(1, 2))
        valid &= hi > lo
        denom = np.where(hi > lo, hi - lo, 1.0)
        return (p - lo[:, None, None]) / denom[:, None, None], valid

    def _tilt_sums_batch(self, tilt, used_angles, coords, tomo_size):
        """Sums of per-tilt crops at the projected coordinates, min-max
        normalized (extract_patches, :113-133; explore_dataset.py:223-296),
        over (M, 3) int coords: every candidate projected into every used
        tilt at once (the affine map of tomo_to_tilt), each tilt's windows
        gathered with one strided fancy-index, borders rejected by mask.

        Accumulation stays sequential over tilts (a python loop over the
        ~41 angles, not over candidates): that order of float addition
        fixes the result bit for bit, as in JAX."""
        b = self.bbox
        half = b // 2
        margin = b // 1.8  # float, like the reference's crop_size//1.8
        xs, ys, zs = tomo_size
        t = len(used_angles)
        m = coords.shape[0]
        if m == 0 or t == 0:
            return np.zeros((m, b, b), np.float32), np.zeros(m, bool)
        x = coords[:, 0].astype(np.float64)
        y = coords[:, 1].astype(np.int64)
        zf = (zs - coords[:, 2]).astype(np.float64)  # z flip, tomo_to_tilt
        a = np.asarray(used_angles, np.float64) * np.pi / 180.0
        cx, cz = xs // 2, zs // 2
        tx_f = (
            (x[:, None] - cx) * np.cos(a)[None, :]
            + (zf[:, None] - cz) * np.sin(a)[None, :]
            + cx
        )
        tx = tx_f.astype(np.int64)  # int() truncation toward zero
        ok = (
            (tx > margin) & (tx < xs - margin)
            & (y[:, None] > margin) & (y[:, None] < ys - margin)
        )
        # window-fits check (the reference's patch-shape guard; margin >
        # half makes this redundant for interior points but tilt images can
        # be smaller than tomo_size in y)
        th, tw = tilt.shape[1], tilt.shape[2]
        ok &= (
            (y[:, None] - half >= 0) & (y[:, None] + half <= th)
            & (tx - half >= 0) & (tx + half <= tw)
        )
        if th < b or tw < b:
            return np.zeros((m, b, b), np.float32), np.zeros(m, bool)
        acc = np.zeros((m, b, b), tilt.dtype)
        win = np.lib.stride_tricks.sliding_window_view(tilt, (b, b), axis=(1, 2))
        yc = np.clip(y - half, 0, th - b)
        xc = np.clip(tx - half, 0, tw - b)
        # chunk the candidate axis so each chunk's accumulator stays
        # cache-resident across the (bit-exactness-preserving) tilt loop;
        # per-candidate accumulation order over tilts is unchanged
        chunk = max(1, (4 << 20) // (b * b * acc.itemsize))
        for c0 in range(0, m, chunk):
            c1 = min(c0 + chunk, m)
            a = acc[c0:c1]
            for ti in range(t):
                sel = ok[c0:c1, ti]
                if not sel.any():
                    continue
                # gather all rows with clipped indices + zero the invalid
                # ones: a plain add is ~7x cheaper than a boolean scatter-add
                g = win[ti, yc[c0:c1], xc[c0:c1, ti]]
                if not sel.all():
                    g[~sel] = 0
                a += g
        valid = ok.any(axis=1)
        p = acc.astype(np.float32)
        lo = p.min(axis=(1, 2))
        hi = p.max(axis=(1, 2))
        valid &= hi > lo
        denom = np.where(hi > lo, hi - lo, 1.0)
        return (p - lo[:, None, None]) / denom[:, None, None], valid

    def _mine_tomogram_vol(self, name, rec):
        """``vol_size`` subvolumes centred on the DoG candidates whose crop
        fits the volume, gathered with one strided fancy-index
        (explore_dataset.py:294-330)."""
        d, h, w = rec.shape
        vz, vy, vx = self.vol_size
        if d < vz or h < vy or w < vx:
            return
        scores, positions = dog_candidates_pyramid(rec, sigmas=self.sigmas,
                                                   device=self.device)
        if positions.shape[0] == 0:
            return
        pos = np.asarray(positions)
        x = pos[:, 0].astype(np.int64)
        y = pos[:, 1].astype(np.int64)
        z = pos[:, 2].astype(np.int64)
        keep = (
            (z - vz // 2 >= 0) & (z - vz // 2 + vz <= d)
            & (y - vy // 2 >= 0) & (y - vy // 2 + vy <= h)
            & (x - vx // 2 >= 0) & (x - vx // 2 + vx <= w)
        )
        kx, ky, kz = x[keep], y[keep], z[keep]
        if kx.shape[0] == 0:
            return
        win = np.lib.stride_tricks.sliding_window_view(rec, (vz, vy, vx))
        vols = win[kz - vz // 2, ky - vy // 2, kx - vx // 2].astype(np.float32)
        for i in range(kx.shape[0]):
            self.subvols.append(vols[i])
            self.coords.append(np.array([kx[i], ky[i], kz[i]], np.float32))
            self.names.append(name)

    def _mine_tomogram(self, name, rec, tilt, angle):
        cfg = self.config
        d, h, w = rec.shape
        tomo_size = (w, h, d * 2 if cfg.compress else d)
        scores, positions = dog_candidates_pyramid(rec, sigmas=self.sigmas,
                                                   device=self.device)
        n = positions.shape[0]
        if n == 0:
            return

        two = self.mode == "2d3d"
        if two:
            used = np.where((angle >= self.low) & (angle <= self.up))[0]
            used_angles = angle[used]
            used_tilt = tilt[used]

        margin = self.bbox // 1.8
        pos = np.asarray(positions)
        x = pos[:, 0].astype(np.int64)
        y = pos[:, 1].astype(np.int64)
        z_rec = pos[:, 2].astype(np.int64)
        z_full = z_rec * 2 if cfg.compress else z_rec
        keep = (
            (x > margin) & (x < tomo_size[0] - margin)
            & (y >= margin) & (y <= tomo_size[1] - margin)
        )
        kx, ky, kz, kzr = x[keep], y[keep], z_full[keep], z_rec[keep]
        k = kx.shape[0]
        if k == 0:
            return

        # anchor + 4 neighbor-offset variants, extracted in ONE batched
        # gather each (the reference loops candidates x tilts in python;
        # SURVEY §3.3's preprocess hot spot)
        train = self.split == "train"
        offs = np.array([(0, 0, 0)] + list(self.AUG_OFFSETS), np.int64)
        offs = offs if train else offs[:1]
        nv = offs.shape[0]
        flat = (
            np.stack([kx, ky, kz], axis=1)[:, None, :] + offs[None, :, :]
        ).reshape(-1, 3)
        p3, v3 = self._slices_batch(rec, flat)
        p3 = p3.reshape(k, nv, self.bbox, self.bbox)
        member_ok = v3.reshape(k, nv)
        if two:
            p2, v2 = self._tilt_sums_batch(used_tilt, used_angles, flat, tomo_size)
            p2 = p2.reshape(k, nv, self.bbox, self.bbox)
            member_ok = member_ok & v2.reshape(k, nv)

        cand_ok = member_ok[:, 0]
        if train:
            cand_ok = cand_ok & member_ok[:, 1:].any(axis=1)

        for i in np.flatnonzero(cand_ok):
            members = np.flatnonzero(member_ok[i])  # anchor (0) first, then
            if train:                               # offsets in AUG_OFFSETS order
                self.aug_sets_3d.append([p3[i, j] for j in members])
                self.aug_sets_2d.append(
                    [p2[i, j] for j in members] if two else [None]
                )
            self.patches_3d.append(p3[i, 0])
            if two:
                self.patches_2d.append(p2[i, 0])
            self.coords.append(
                np.array([kx[i], ky[i], kzr[i]], dtype=np.float32)
            )
            self.names.append(name)

    # -- sampling ------------------------------------------------------------

    def __len__(self):
        return self.num_samples

    def sample_batch(self, rng: np.random.Generator, indices):
        """Raw (un-augmented) anchor + aug-set-member patch stacks.

        Returns dict of (B, C, bbox, bbox) float32 with C=2 for 2d3d
        ((tilt, slice) stacked, sharing spatial augs like the reference's
        2-channel Compose) or C=1 for 3d; (B, *vol_size) in vol mode, both
        views the same subvolume (particle_pre.py transforms it twice).
        On-device augmentation (ops/augment.py) consumes these.
        """
        if self.mode == "vol":
            v = np.stack([self.subvols[int(i)] for i in indices])
            return {"anchor": v.astype(np.float32),
                    "aug": v.astype(np.float32)}
        anchors, augs = [], []
        for i in indices:
            i = int(i)
            set3d = self.aug_sets_3d[i]
            pick = int(rng.integers(1, len(set3d)))
            if self.mode == "2d3d":
                set2d = self.aug_sets_2d[i]
                anchors.append(np.stack([set2d[0], set3d[0]]))
                augs.append(np.stack([set2d[pick], set3d[pick]]))
            else:
                anchors.append(set3d[0][None])
                augs.append(set3d[pick][None])
        return {
            "anchor": np.stack(anchors).astype(np.float32),
            "aug": np.stack(augs).astype(np.float32),
        }

    def epoch_batches(self, rng: np.random.Generator, batch_size, drop_last=True):
        order = rng.permutation(self.num_samples)
        n_full = len(order) // batch_size
        for b in range(n_full):
            yield self.sample_batch(rng, order[b * batch_size : (b + 1) * batch_size])
        if not drop_last and len(order) % batch_size:
            yield self.sample_batch(rng, order[n_full * batch_size :])

    def test_items(self):
        """Per-candidate (name, coord, patch2d, patch3d) for embedding
        extraction (simsiam_test_hm_2d3d.py:33-71); in vol mode the last
        element is the raw subvolume."""
        for i in range(self.num_samples):
            if self.mode == "vol":
                yield self.names[i], self.coords[i], None, self.subvols[i]
                continue
            p2 = self.patches_2d[i] if self.mode == "2d3d" else None
            yield self.names[i], self.coords[i], p2, self.patches_3d[i]
