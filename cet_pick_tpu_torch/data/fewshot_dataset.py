"""Few-shot (task ``fs``) dataset: labeled-point crops — a copy of
``cet_pick_tpu/data/fewshot_dataset.py:39-199`` on the port's coordinate
tables (columns, no pandas), whose numpy draws keep JAX's order exactly, so
that one seed gives byte-identical batches in both packages.

Rebuild of the reference's fewshot data path (reference:
cet_pick/datasets/tomo_fewshot.py:48-132 +
cet_pick/datasets/particle_fewshot.py:16-115):

* coordinate tables carry a 4th ``label`` column: 1 = target-class particle,
  2 = other/negative exemplar (tomo_fewshot.py:96-116);
* per tomogram: a gaussian heatmap target over the *class-1* particles only,
  and a point ``lb_map`` marking annotation voxels with their class
  (1 or 2) — everything else 0 / unlabeled;
* a training sample crops a (10, 128, 128) input window (full res) and the
  matching (10, 64, 64) heatmap + label windows around a random class-1
  annotation (particle_fewshot.py:36-104).

The crop's ``lb_map`` window is the constraint set of the constrained
k-means (train/fewshot.py): labeled pixels are its hard seeds.
"""

from __future__ import annotations

import math
import os

import numpy as np

from cet_pick_tpu_torch.io.coords import read_coord_table, read_image_list
from cet_pick_tpu_torch.io.loader import (
    QuantizedTomo,
    load_tomos_quantized_from_list,
)
from cet_pick_tpu_torch.ops.heatmap import (
    downscale_coord,
    draw_gaussian_3d,
    gaussian_radius,
)


def build_fewshot_maps(tomo_shape, coords, labels, bbox=32, down_ratio=2,
                       compress=False):
    """Gaussian hm over class-1 + point label map (tomo_fewshot.py:85-118).

    Returns (hm, lb_map, gt_det): hm (D, H', W') float32; lb_map same shape
    with values {0, 1, 2}; gt_det the (n1, 3) class-1 downscaled coords.
    """
    depth, height, width = tomo_shape
    output_h, output_w = height // down_ratio, width // down_ratio
    hm = np.zeros((depth, output_h, output_w), dtype=np.float32)
    lb_map = np.zeros((depth, output_h, output_w), dtype=np.float32)
    h = bbox // down_ratio
    radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(h)))))
    gt_det = []
    for ann, lb in zip(coords, labels):
        ct = np.asarray(
            downscale_coord(ann, down_ratio=down_ratio, compress=compress),
            dtype=np.int32,
        )
        if not (0 <= ct[0] < output_w and 0 <= ct[1] < output_h
                and 0 <= ct[2] < depth):
            continue
        if lb == 1:
            lb_map[ct[2], ct[1], ct[0]] = 1
            draw_gaussian_3d(hm, ct, radius, discrete=False)
            gt_det.append(ct)
        elif lb == 2:
            lb_map[ct[2], ct[1], ct[0]] = 2
    gt_det = (np.array(gt_det, dtype=np.float32) if gt_det
              else np.zeros((1, 3), dtype=np.float32))
    return hm, lb_map, gt_det


def _rows_of(table, name):
    """(coords (n, 3) int32, labels (n,) int32) of ``name``'s rows, in the
    table's order."""
    rows = [i for i, n in enumerate(table["image_name"]) if n == name]
    coords = np.array([[table[k][i] for k in ("x_coord", "y_coord",
                                              "z_coord")] for i in rows])
    labels = np.array([table["label"][i] for i in rows])
    return (coords.astype(np.int32).reshape(-1, 3),
            labels.astype(np.int32).reshape(-1))


class FewshotDataset:
    """Class-1-annotation-indexed crop sampler with label windows."""

    def __init__(self, config, split="train", images=None, coord_table=None,
                 crop_d=10, crop_xy=128):
        self.config = config
        self.split = split
        self.crop_d = crop_d
        self.crop_xy = crop_xy
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

        if "label" not in coord_table:
            raise ValueError(
                "fewshot coordinate tables need a `label` column "
                "(1 = target class, 2 = other; tomo_fewshot.py:96-116)"
            )
        self.names, self.tomos, self.hms, self.lb_maps, self.gt_dets = (
            [], [], [], [], [])
        self.all_anns = []  # (x_down, y_down, z, tomo_index) of class-1 anns
        for i, (name, tomo) in enumerate(images.items()):
            coords, labels = _rows_of(coord_table, name)
            if not isinstance(tomo, QuantizedTomo):  # keep the uint8 store
                tomo = np.asarray(tomo, np.float32)
            hm, lb_map, gt_det = build_fewshot_maps(
                tomo.shape, coords, labels,
                bbox=config.bbox, down_ratio=config.down_ratio,
                compress=config.compress,
            )
            self.names.append(name)
            self.tomos.append(tomo)
            self.hms.append(hm)
            self.lb_maps.append(lb_map)
            self.gt_dets.append(gt_det)
            for ann in gt_det.astype(np.int32):
                self.all_anns.append((int(ann[0]), int(ann[1]), int(ann[2]), i))
        if split == "train" and not self.all_anns:
            raise ValueError("no class-1 annotations — nothing to train on")
        self.num_samples = (len(self.all_anns) if split == "train"
                            else len(self.names))

    def __len__(self):
        return self.num_samples

    def sample(self, rng: np.random.Generator, index: int):
        """One crop around a class-1 annotation (particle_fewshot.py:55-104)."""
        cfg = self.config
        xc, yc, zc, ti = self.all_anns[index % len(self.all_anns)]
        tomo, hm, lb = self.tomos[ti], self.hms[ti], self.lb_maps[ti]
        d, hgt, wid = tomo.shape
        # heatmap-grid half widths, clamped so the window always fits (a
        # crop as wide as the volume would invert the clip bounds)
        half_x = min(self.crop_xy, wid) // 2 // cfg.down_ratio
        half_y = min(self.crop_xy, hgt) // 2 // cfg.down_ratio
        dz = min(self.crop_d, d) // 2

        def center(c, half, grid):
            lo, hi = half + 1, grid - half - 1
            return grid // 2 if hi < lo else int(np.clip(c, lo, hi))

        xc = center(xc, half_x, wid // cfg.down_ratio)
        yc = center(yc, half_y, hgt // cfg.down_ratio)
        zc = int(np.clip(zc, dz, max(dz, d - dz)))
        ux, uy = xc * cfg.down_ratio, yc * cfg.down_ratio
        uhx, uhy = half_x * cfg.down_ratio, half_y * cfg.down_ratio

        ct = tomo[zc - dz : zc + dz, uy - uhy : uy + uhy,
                  ux - uhx : ux + uhx]
        ch = hm[zc - dz : zc + dz, yc - half_y : yc + half_y,
                xc - half_x : xc + half_x]
        cl = lb[zc - dz : zc + dz, yc - half_y : yc + half_y,
                xc - half_x : xc + half_x]

        # the fs step reads only input + lb_map; flip_prob is still drawn
        # to keep the stream
        flip_prob = rng.random()
        return {
            "input": ct.astype(np.float32),
            "hm": ch.astype(np.float32),
            "lb_map": cl.astype(np.float32),
            "flip_prob": np.float32(flip_prob),
        }

    def sample_batch(self, rng: np.random.Generator, indices):
        samples = [self.sample(rng, int(i)) for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def epoch_batches(self, rng: np.random.Generator, batch_size,
                      drop_last=True):
        order = rng.permutation(self.num_samples)
        n_full = len(order) // batch_size
        for b in range(n_full):
            yield self.sample_batch(rng, order[b * batch_size : (b + 1) * batch_size])
        if not drop_last and len(order) % batch_size:
            yield self.sample_batch(rng, order[n_full * batch_size :])

    def val_item(self, i):
        tomo, hm, lb = self.tomos[i], self.hms[i], self.lb_maps[i]
        return {
            "input": tomo.astype(np.float32)[None],
            "hm": hm[None],
            "lb_map": lb[None],
            "name": self.names[i],
            "gt_det": self.gt_dets[i],
        }
