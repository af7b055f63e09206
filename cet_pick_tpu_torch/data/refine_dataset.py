"""Refinement training dataset: paired particle crops from annotated
tomograms — a copy of ``cet_pick_tpu/data/refine_dataset.py:32-216``, whose
numpy draws keep JAX's order exactly, so that one seed gives identical
batches in both packages.

Host-side rebuild of the reference's TOMOMoco + ParticleMocoDataset
(reference: cet_pick/datasets/tomo_moco.py:19-141,
cet_pick/datasets/particle_moco.py:16-185):

* volumes + full-volume gaussian targets are materialized once at init
  (tomo_moco.py:75-131); unlabeled voxels are -1 in PU mode (:122-124)
* each training sample is an annotation: a 6 x 64 x 64 input window (full
  res) and a 6 x 32 x 32 target window (half res) around the jittered
  annotation, plus a second window around *another* random annotation
  (translation-jittered with prob 0.8), stacked into a pair; the flipped
  view (lr or ud by one coin per sample) is made on the device from
  ``flip_prob`` (particle_moco.py:35-163)
* validation returns whole tomograms (subregion-cropped if very large,
  particle_moco.py:171-177)

Batches carry a per-sample ``flip_prob`` vector, so the train step un-flips
each sample on its own at any batch size.
"""

from __future__ import annotations

import os

import numpy as np

from cet_pick_tpu_torch.io.coords import (
    match_coordinates_to_images,
    read_coord_table,
    read_image_list,
)
from cet_pick_tpu_torch.io.loader import (
    QuantizedTomo,
    load_tomos_quantized_from_list,
)
from cet_pick_tpu_torch.ops.heatmap import build_heatmap

CROP_D, CROP_HALF_XY, CROP_HM_HALF = 6, 32, 16  # particle_moco.py:132-137


def crop_hm_half(down_ratio: int) -> int:
    """Heatmap-crop half-width pairing the fixed 64-px input crop with the
    model's output stride: 16 at the reference down_ratio 2
    (CROP_HM_HALF), 8 at the unetw arch's quarter-res grid."""
    return CROP_HALF_XY // int(down_ratio)


class RefineDataset:
    """Annotation-indexed crop sampler over preloaded tomograms."""

    def __init__(self, config, split="train", images=None, coord_table=None):
        self.config = config
        self.split = split

        if images is None:
            img_txt = {
                "train": config.train_img_txt,
                "val": config.val_img_txt,
                "test": config.test_img_txt,
            }[split]
            coord_txt = {
                "train": config.train_coord_txt,
                "val": config.val_coord_txt,
                "test": config.test_coord_txt,
            }[split]
            il = read_image_list(os.path.join(config.data_dir, img_txt))
            # volumes stay uint8-resident (4x less host RAM); crops
            # dequantize bit-identically on access (io/loader.QuantizedTomo)
            images = load_tomos_quantized_from_list(
                il["image_name"], il["rec_path"],
                order=config.order, compress=config.compress, denoise=config.gauss,
            )
            coord_table = read_coord_table(os.path.join(config.data_dir, coord_txt))

        matched = match_coordinates_to_images(coord_table, images)
        self.names, self.tomos, self.hms, self.inds, self.gt_dets = [], [], [], [], []
        self.all_anns = []  # rows (x_down, y_down, z, tomo_index)
        pu = not config.pn
        for i, (name, entry) in enumerate(matched.items()):
            tomo = entry["tomo"]
            if not isinstance(tomo, QuantizedTomo):  # keep the uint8 store
                tomo = np.asarray(tomo, np.float32)
            hm, inds, gt_det, anns = build_heatmap(
                tomo.shape, entry["coord"],
                bbox=config.bbox, down_ratio=config.down_ratio,
                compress=config.compress, fiber=config.fiber,
                pu=pu, train=(split == "train"),
            )
            self.names.append(name)
            self.tomos.append(tomo)
            self.hms.append(hm)
            self.inds.append(inds)
            self.gt_dets.append(gt_det)
            for ann in anns:
                self.all_anns.append((int(ann[0]), int(ann[1]), int(ann[2]), i))
        self.num_samples = len(self.all_anns) if split == "train" else len(self.names)
        if split == "train" and len(self.all_anns) < 2:
            # the partner-crop draw needs another annotation to pair with
            # (particle_moco.py pairs every sample with a different one);
            # fail here with a clear message instead of an opaque
            # rng.integers(0, 0) ValueError on the first sample
            raise ValueError(
                f"refinement training needs >= 2 annotations, got "
                f"{len(self.all_anns)} — add more coordinates to the train "
                f"coord file"
            )

    def __len__(self):
        return self.num_samples

    # -- crop helpers -------------------------------------------------------

    def _crop_pair(self, tomo, hm, xc, yc, zc):
        """6-slice crops at heatmap coords (xc, yc) (particle_moco.py:129-137)."""
        dr = self.config.down_ratio
        hh = crop_hm_half(dr)
        ux, uy = xc * dr, yc * dr
        ct = tomo[zc - 3 : zc + 3, uy - CROP_HALF_XY : uy + CROP_HALF_XY,
                  ux - CROP_HALF_XY : ux + CROP_HALF_XY]
        ch = hm[zc - 3 : zc + 3, yc - hh : yc + hh, xc - hh : xc + hh]
        return ct, ch

    def _clip_center(self, x, y, z, shape):
        # heatmap-grid bounds from down_ratio + the crop half-width (the
        # sibling classify_dataset computes the same; a hardcoded
        # `width // 2 - 17` silently broke any down_ratio other than 2)
        depth, height, width = shape
        dr = self.config.down_ratio
        m = crop_hm_half(dr) + 1
        x = int(np.clip(x, m, width // dr - m))
        y = int(np.clip(y, m, height // dr - m))
        z = int(np.clip(z, 3, depth - 3))
        return x, y, z

    def sample(self, rng: np.random.Generator, index: int):
        """One training sample: paired crops + flipped copy (particle_moco.py:35-163)."""
        cfg = self.config
        xc, yc, zc, ti = self.all_anns[index]
        tomo, hm = self.tomos[ti], self.hms[ti]

        translation_pixels = int(cfg.bbox * cfg.translation_ratio)
        flip_prob = rng.random()
        p = rng.random()

        # anchor jitter: +-4 in heatmap xy, z unchanged (particle_moco.py:49-53,124-127)
        off = rng.integers(-4, 5, size=2)
        xa, ya, za = self._clip_center(xc + off[0], yc + off[1], zc, tomo.shape)

        # partner crop around another annotation (or random position in pn mode)
        sel = rng.integers(0, len(self.all_anns) - 1)
        if sel >= index:
            sel += 1
        xp, yp, zp, tp = self.all_anns[sel]
        tomo_p, hm_p = self.tomos[tp], self.hms[tp]
        if cfg.pn and p <= 0.5:
            xp = rng.integers(0, tomo_p.shape[2])
            yp = rng.integers(0, tomo_p.shape[1])
            zp = rng.integers(0, tomo_p.shape[0])
        elif cfg.pn:
            # translation_pixels can be 0 (tiny bbox or translation_ratio
            # 0): no xy jitter then — rng.integers(0, 0) would raise
            if translation_pixels > 0:
                xp += rng.integers(-translation_pixels, translation_pixels)
                yp += rng.integers(-translation_pixels, translation_pixels)
            zp += rng.integers(-5, 5)
        elif p <= 0.8:
            xp += rng.integers(-5, 5)
            yp += rng.integers(-5, 5)
            zp += rng.integers(-2, 2)
        else:
            xp += rng.integers(-translation_pixels, translation_pixels)
            yp += rng.integers(-translation_pixels, translation_pixels)
            zp += rng.integers(-2, 2)
        xp, yp, zp = self._clip_center(xp, yp, zp, tomo_p.shape)

        ct_a, ch_a = self._crop_pair(tomo, hm, xa, ya, za)
        ct_p, ch_p = self._crop_pair(tomo_p, hm_p, xp, yp, zp)
        pair_t = np.stack([ct_a, ct_p]).astype(np.float32)   # (2, 6, 64, 64)
        pair_h = np.stack([ch_a, ch_p]).astype(np.float32)   # (2, 6, 32, 32)

        # the aug view (lr flip if flip_prob <= 0.5 else ud,
        # particle_moco.py:145-154) is made on the device inside the train
        # step from input + flip_prob (train/refine.py); shipping a flipped
        # copy would double the batch's host->device bytes
        return {
            "input": pair_t,
            "hm": pair_h,
            "flip_prob": np.float32(flip_prob),
        }

    def sample_batch(self, rng: np.random.Generator, indices):
        """Stack samples -> batch dict with leading batch axis."""
        samples = [self.sample(rng, int(i)) for i in indices]
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        }

    def epoch_batches(self, rng: np.random.Generator, batch_size, drop_last=True):
        """Shuffled epoch iterator (DataLoader shuffle + drop_last semantics)."""
        order = rng.permutation(self.num_samples)
        n_full = len(order) // batch_size
        for b in range(n_full):
            yield self.sample_batch(rng, order[b * batch_size : (b + 1) * batch_size])
        if not drop_last and len(order) % batch_size:
            yield self.sample_batch(rng, order[n_full * batch_size :])

    # -- validation / test access ------------------------------------------

    def val_item(self, i):
        """Whole-volume validation item (particle_moco.py:164-177)."""
        tomo, hm = self.tomos[i], self.hms[i]
        if tomo.shape[0] >= 100 and tomo.shape[1] > 512:
            tomo = tomo[:110, 200:700, 200:700]
            hm = hm[:110, 100:350, 100:350]
        return {
            "input": tomo.astype(np.float32)[None],
            "hm": hm[None],
            "name": self.names[i],
            "gt_det": self.gt_dets[i],
        }
