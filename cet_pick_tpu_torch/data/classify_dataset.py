"""Semiclass training dataset: voxel-centric crops with fill/unfill labels —
a copy of ``cet_pick_tpu/data/classify_dataset.py``, whose numpy draws keep
JAX's order exactly, so that one seed gives identical batches in both
packages.

Rebuild of the reference's semiclass data path (reference:
cet_pick/datasets/tomo_classify_moco.py:19-146 +
cet_pick/datasets/particle_moco_classify.py:16-155):

* full-volume *discrete* gaussian label maps ("fill/unfill masking",
  tomo_classify_moco.py:119-139): each annotation splats a thresholded
  gaussian; voxels with gaussian value >= 0.5 become confident positives
  (label 1), the surrounding ring soft negatives (label 0.1); fiber mode
  uses (1, 0) at threshold 0.2. In PU mode every untouched voxel is -1
  (unlabeled), tomo_classify_moco.py:137-139.
* training samples are *voxels*, drawn by ``StratifiedCoordinateSampler``
  (data/sampler.py) between positive-core and other voxels, since uniform
  voxel draws almost never hit a positive.
* each sample crops a (6, 64, 64) input window and the matching
  (6, 64 / down_ratio, 64 / down_ratio) label window around the drawn voxel,
  with a per-sample flip flag; the flipped view is made on the device by
  the shared refinement step (train/refine.py). Batches carry a pair axis
  of size 1, (B, 1, D, H, W), for that step.

As in JAX, the label *window* is the target, where the reference's trainer
broadcasts the centre voxel's scalar label (tomo_cr_semi_class_trainer.py:58);
the centre label still travels in the batch as ``label``.
"""

from __future__ import annotations

import math
import os

import numpy as np

from cet_pick_tpu_torch.data.refine_dataset import (
    CROP_D,
    CROP_HALF_XY,
    crop_hm_half,
)
from cet_pick_tpu_torch.data.sampler import StratifiedCoordinateSampler
from cet_pick_tpu_torch.io.coords import (
    match_coordinates_to_images,
    read_coord_table,
    read_image_list,
)
from cet_pick_tpu_torch.io.loader import (
    QuantizedTomo,
    load_tomos_quantized_from_list,
)
from cet_pick_tpu_torch.ops.heatmap import (
    downscale_coord,
    draw_gaussian_3d,
    gaussian_radius,
)


def build_class_heatmap(tomo_shape, coords, bbox=32, down_ratio=2,
                        compress=False, fiber=False, pu=True, train=True):
    """Discrete fill/unfill label volume for one tomogram
    (classify_dataset.py:55-88, tomo_classify_moco.py:102-143).

    Returns (hm, gt_det): hm is (D, H//down_ratio, W//down_ratio) float32 with
    values {1 (core), 0.1 (ring) | 0 (fiber ring), -1 (unlabeled, PU train)};
    gt_det is the (n, 3) downscaled annotation table.
    """
    depth, height, width = tomo_shape
    output_h, output_w = height // down_ratio, width // down_ratio
    hm = np.zeros((depth, output_h, output_w), dtype=np.float32)
    h = bbox // down_ratio
    radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(h)))))
    gt_det = []
    for ann in coords:
        ct = np.asarray(
            downscale_coord(ann, down_ratio=down_ratio, compress=compress),
            dtype=np.int32,
        )
        if not (0 <= ct[0] < output_w and 0 <= ct[1] < output_h
                and 0 <= ct[2] < depth):
            continue
        if fiber:
            draw_gaussian_3d(hm, ct, radius, 1, 0, 0.2, discrete=True)
        else:
            draw_gaussian_3d(hm, ct, radius, 1, 0.1, 0.5, discrete=True)
        gt_det.append(ct)
    gt_det = (np.array(gt_det, dtype=np.float32) if gt_det
              else np.zeros((1, 3), dtype=np.float32))
    if train and pu:
        hm[hm == 0] = -1
    return hm, gt_det


class SemiClassDataset:
    """Stratified voxel-crop sampler over fill/unfill label volumes
    (classify_dataset.py:91-238)."""

    def __init__(self, config, split="train", images=None, coord_table=None,
                 balance=0.5):
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
            # uint8-resident volumes, bit-identical crops (io/loader)
            images = load_tomos_quantized_from_list(
                il["image_name"], il["rec_path"],
                order=config.order, compress=config.compress,
                denoise=config.gauss,
            )
            coord_table = read_coord_table(
                os.path.join(config.data_dir, coord_txt))

        matched = match_coordinates_to_images(coord_table, images)
        self.names, self.tomos, self.hms, self.gt_dets = [], [], [], []
        self._samplers = []
        self.balance = balance
        pu = not config.pn
        for name, entry in matched.items():
            tomo = entry["tomo"]
            if not isinstance(tomo, QuantizedTomo):  # keep the uint8 store
                tomo = np.asarray(tomo, np.float32)
            hm, gt_det = build_class_heatmap(
                tomo.shape, entry["coord"],
                bbox=config.bbox, down_ratio=config.down_ratio,
                compress=config.compress, fiber=config.fiber,
                pu=pu, train=(split == "train"),
            )
            if split == "train" and not (hm == 1).any():
                raise ValueError(
                    f"tomogram {name!r} has no positive-core voxels — check "
                    "--bbox and the coordinate files"
                )
            self.names.append(name)
            self.tomos.append(tomo)
            self.hms.append(hm)
            self.gt_dets.append(gt_det)
        # the reference's nominal epoch is every voxel of every tomogram
        # (tomo_classify_moco.py:48); one epoch here is num_iters (else 512)
        # stratified draws per tomogram, as in JAX
        per_tomo = config.num_iters if config.num_iters > 0 else 512
        self.num_samples = (per_tomo * len(self.names)
                            if split == "train" else len(self.names))

    def __len__(self):
        return self.num_samples

    def _sampler(self, rng, ti):
        # built at first use: it enumerates every voxel of the label volume
        while len(self._samplers) <= ti:
            self._samplers.append(None)
        if self._samplers[ti] is None:
            self._samplers[ti] = StratifiedCoordinateSampler(
                self.hms[ti], thresh=0.5, balance=self.balance,
                random=rng, split="pu",
            )
        return self._samplers[ti]

    def _clip_center(self, x, y, z, shape):
        depth, height, width = shape
        hh = crop_hm_half(self.config.down_ratio)
        x = int(np.clip(x, hh + 1, width // self.config.down_ratio - hh - 1))
        y = int(np.clip(y, hh + 1, height // self.config.down_ratio - hh - 1))
        z = int(np.clip(z, CROP_D // 2, depth - CROP_D // 2))
        return x, y, z

    def sample(self, rng: np.random.Generator, index: int):
        """One training sample: input/label crop pair around a drawn voxel
        (particle_moco_classify.py:42-122)."""
        cfg = self.config
        ti = index % len(self.names)
        tomo, hm = self.tomos[ti], self.hms[ti]
        _, h_hm, w_hm = hm.shape

        flat = next(self._sampler(rng, ti))
        zc = flat // (h_hm * w_hm)
        rest = flat - zc * h_hm * w_hm
        yc = rest // w_hm
        xc = rest % w_hm
        xc, yc, zc = self._clip_center(xc, yc, zc, tomo.shape)

        dr = cfg.down_ratio
        ux, uy = xc * dr, yc * dr
        ct = tomo[zc - CROP_D // 2 : zc + CROP_D // 2,
                  uy - CROP_HALF_XY : uy + CROP_HALF_XY,
                  ux - CROP_HALF_XY : ux + CROP_HALF_XY]
        hh = crop_hm_half(dr)
        ch = hm[zc - CROP_D // 2 : zc + CROP_D // 2,
                yc - hh : yc + hh, xc - hh : xc + hh]

        flip_prob = rng.random()
        return {
            "input": ct.astype(np.float32),
            "hm": ch.astype(np.float32),
            "label": np.float32(hm[zc, yc, xc]),
            "flip_prob": np.float32(flip_prob),
        }

    def sample_batch(self, rng: np.random.Generator, indices):
        samples = [self.sample(rng, int(i)) for i in indices]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        # the pair axis of size 1 that the refinement step folds
        for k in ("input", "hm"):
            batch[k] = batch[k][:, None]
        return batch

    def epoch_batches(self, rng: np.random.Generator, batch_size,
                      drop_last=True):
        n_full = self.num_samples // batch_size
        for b in range(n_full):
            yield self.sample_batch(
                rng, range(b * batch_size, (b + 1) * batch_size)
            )
        if not drop_last and self.num_samples % batch_size:
            yield self.sample_batch(
                rng, range(n_full * batch_size, self.num_samples)
            )

    def val_item(self, i):
        """Whole-volume validation item (particle_moco_classify.py:127-142):
        a volume deeper than 100 slices and wider than 512 px is cut to its
        110 x 500 x 500 subregion (classify_dataset.py:230-232)."""
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
