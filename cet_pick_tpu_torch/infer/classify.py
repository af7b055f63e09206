"""Semiclass inference: tiled forward -> border zeroing -> greedy ball NMS —
port of ``cet_pick_tpu/infer/classify.py``.

Reference cet_pick/detectors/tomo_det_classify.py:77-217 +
test_class.py:47-78:

* the probability volume comes from the same tiled z-window forward as the
  semi detector (infer/tiled.py); on the card its 3D head runs the z-tap
  kernel;
* a 30-HEATMAP-voxel xy border is zeroed before decoding: the reference
  indexes ``out_hm``, its down_ratio-grid model output, so the band is 30
  heatmap voxels (60 input pixels at down_ratio 2), not 30 input pixels
  (tomo_det_classify.py:106-109);
* decoding is greedy spherical NMS on the host with exclusion diameter
  ``--nms`` and score floor ``--out_thresh`` (ops/decode.tomo_decode_classify);
* outputs match the reference writers: ``{name}.txt`` rows ``x\\tz\\ty``
  after the score / z-cutoff / border filters and ``{name}_hm.mrc`` with y/z
  swapped (tomo_det_classify.py:172-216), through the refine detector's
  ``write_detection_outputs``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from cet_pick_tpu_torch.infer.detector import (
    TomoDetector,
    set_float32_precision,
    stream_quantized_volumes,
    warm_from_header,
    write_detection_outputs,
)
from cet_pick_tpu_torch.io.coords import read_image_list
from cet_pick_tpu_torch.ops.decode import tomo_decode_classify


class TomoClassDetector(TomoDetector):
    """Semiclass picker: greedy-NMS decode over the tiled heatmap
    (classify.py:32-127)."""

    BORDER = 30  # heatmap voxels zeroed at the xy edges (classify.py:35-38)

    def process(self, volume, lo: float = 0.0, hi: float = 1.0,
                fused: bool = True):
        """Tiled forward + greedy spherical NMS; returns (hm, (N, 4) dets),
        both on the host. Rows are (x, y, z, score) on the heatmap grid.

        The ``cutoff_z`` planes at each end are zeroed on a decode-only copy
        (the saved ``_hm.mrc`` keeps them), mirroring the writer's inclusive
        upper bound: z <= depth - cutoff_z survives (classify.py:62-73)."""
        cfg = self.config
        if fused:
            hm = self.infer.fused(volume, lo=lo, hi=hi)
        else:
            hm = self.infer(volume, lo=lo, hi=hi)
        hm = hm.cpu().numpy()
        b = self.BORDER
        hm[:, :b, :] = 0
        hm[:, -b:, :] = 0
        hm[:, :, :b] = 0
        hm[:, :, -b:] = 0
        if cfg.cutoff_z > 0:
            hm_dec = hm.copy()
            hm_dec[: cfg.cutoff_z] = 0
            hm_dec[hm.shape[0] - cfg.cutoff_z + 1:] = 0
        else:
            hm_dec = hm
        dets = tomo_decode_classify(hm_dec, cfg.nms, cfg.out_thresh)
        return hm, dets

    def warm(self, shape):
        """Run the device half only (classify.py:74-85): greedy NMS of a
        constant heatmap would visit nearly every voxel on the host."""
        v = torch.zeros(tuple(int(s) for s in shape), dtype=torch.uint8,
                        device=self.device)
        hm = self.infer.fused(v, lo=0.0, hi=1.0)
        hm[0, 0, 0].item()  # drain: the next run starts clean

    def post_process(self, dets: np.ndarray, z_dim_tot: int = None):
        """xy back to input resolution (tomo_det_classify.py:158-170)."""
        dets = np.asarray(dets, dtype=np.float32).copy()
        if len(dets):
            dets[:, :2] *= self.config.down_ratio
        return dets

    def run(self, volume, name: str = "tomo", out_dir: Optional[str] = None,
            lo: float = 0.0, hi: float = 1.0) -> Dict:
        """Full semiclass picking pipeline for one tomogram, with the wall
        seconds of each stage: ``net+dec`` (forward, heatmap fetch, border
        zeroing and the greedy NMS), ``post``, ``save`` and ``tot``."""
        t0 = time.perf_counter()
        hm, dets = self.process(volume, lo=lo, hi=hi)
        t_net = time.perf_counter()
        dets = self.post_process(dets)
        t_post = time.perf_counter()
        ret = {"name": name, "hm": hm, "dets": dets,
               "times": {"net+dec": t_net - t0, "post": t_post - t_net}}
        if out_dir is not None:
            self.save_detection(hm, dets, out_dir, name)
            ret["times"]["save"] = time.perf_counter() - t_post
        ret["times"]["tot"] = time.perf_counter() - t0
        return ret

    def save_detection(self, hm: np.ndarray, dets: np.ndarray, path: str,
                       name: str):
        """Write ``{name}_hm.mrc`` + filtered ``{name}.txt``
        (tomo_det_classify.py:172-216)."""
        rows = np.asarray(dets, dtype=np.float32).reshape(-1, 4)
        return write_detection_outputs(self.config, hm, rows, path, name)


def run_classify_test(config, out_dir=None, device="cuda"):
    """test_class.py equivalent (classify.py:129-150): semiclass picking over
    the test image list, with the producer thread loading and quantizing
    volume i+1 while volume i computes. Returns {name: stage times}."""
    set_float32_precision(config.dtype)
    il = read_image_list(os.path.join(config.data_dir, config.test_img_txt))
    det = TomoClassDetector(config, device=device)
    out_dir = out_dir or config.out_path
    results = {}
    with stream_quantized_volumes(config, il["image_name"], il["rec_path"],
                                  det.device) as vols:
        warm_from_header(det, il["rec_path"], config)
        for name, v_dev, lo, hi in vols:
            r = det.run(v_dev, name=name, out_dir=out_dir, lo=lo, hi=hi)
            print(f"{name}: " + " ".join(
                f"{k} {v:.3f}s" for k, v in r["times"].items()))
            results[name] = r["times"]
    return results
