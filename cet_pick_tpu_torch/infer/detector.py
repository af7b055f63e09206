"""Inference pipeline: checkpoint -> tiled forward -> decode -> coordinate
files. Port of ``cet_pick_tpu/infer/detector.py``.

Reference cet_pick/detectors/base_detector.py:22-106 +
detectors/tomo_det.py:18-95:

* ``TomoDetector.run``  — forward (tiled, see infer/tiled.py) -> sigmoid +
                          NMS + top-K decode on the device -> per-stage
                          wall-clock dict (base_detector.py:62-106)
* ``post_process``      — x,y scaled by down_ratio, grouped by z slice
                          (tomo_det.py:42-51)
* ``save_detection``    — writes ``{name}_hm.mrc`` (y/z axes swapped, NaN
                          check) and ``{name}.txt`` rows ``x\tz\ty[\tscore]``
                          after score/border filters; fiber/spike modes run
                          the curve/group post-processing first
                          (tomo_det.py:53-95)

Forward and decode stay on the device; only the (K, 5) detection table and
the final heatmap cross back to the host.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from cet_pick_tpu_torch.data.prefetch import PrefetchIterator
from cet_pick_tpu_torch.infer.tiled import Z_HALO, TiledHeatmapInference
from cet_pick_tpu_torch.io.coords import read_image_list
from cet_pick_tpu_torch.io.loader import (
    load_rec,
    predict_loaded_shape,
    preprocess_quantized,
)
from cet_pick_tpu_torch.io.mrc import write_mrc
from cet_pick_tpu_torch.models.convert import load_checkpoint
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.utils.post_process import (
    fiber_postprocess,
    group_dets_by_z,
    spike_group_postprocess,
)
from cet_pick_tpu_torch.utils.profiling import annotate, maybe_trace


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point; raises when CUDA is asked for
    and none is present (there is no silent CPU run)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch sees no CUDA device; "
            "pass --device cpu (device='cpu') to run on the CPU")
    return device


def set_float32_precision(dtype: str):
    """Under ``float32`` keep convolutions and matmuls in full f32: cuDNN's
    f32 convs default to TF32 (about 3 decimal digits), and the port is held
    to f32 parity with the JAX package."""
    if dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class TomoDetector:
    """Loads a trained refinement checkpoint and picks particles from volumes.

    ``state_dict``: the model's weights; read from ``config.load_model``
    (a ``.pth``) when None. ``xy_budget``: activation budget of the memory
    envelope in bytes (see infer/tiled.py); None sizes it from the device.
    """

    def __init__(self, config, state_dict=None, tile_z=None, device="cuda",
                 xy_budget=None):
        self.device = resolve_device(device)
        if tile_z is None:
            tile_z = int(config.tile[0])  # --tile D H W
        tile_xy = tuple(config.tile[1:]) if len(config.tile) >= 3 else None
        halo = max(int(config.halo), Z_HALO)  # smaller would break exactness
        self.config = config
        self.model = create_detector(config)
        # res3dref halves z as well: decoded z rescales like xy (:61-64);
        # the 3D detectors run untiled (infer/tiled, detector.py:48-57)
        self.z_ratio = getattr(self.model, "z_ratio", 1)
        if state_dict is None:
            state_dict = load_checkpoint(config.load_model, arch=config.arch)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.infer = TiledHeatmapInference(
            self.model, tile_z=tile_z, halo=halo, tile_xy=tile_xy,
            tta=config.tta, xy_budget=xy_budget,
        )

    # -- pipeline stages -----------------------------------------------------

    def process(self, volume, lo: float = 0.0, hi: float = 1.0,
                fused: bool = True):
        """Tiled forward + decode; returns (hm probs, (K,5) dets), both on
        the device.

        Pass a uint8 volume with (lo, hi) from preprocess_quantized to cut
        the host->device transfer 4x (dequantized on the device).
        fused=True batches all z windows through one forward (fastest);
        fused=False streams window by window (lowest peak memory)."""
        cfg = self.config
        if fused:
            hm = self.infer.fused(volume, lo=lo, hi=hi)
        else:
            hm = self.infer(volume, lo=lo, hi=hi)
        dets = tomo_decode(hm, kernel=cfg.nms, k=cfg.K, if_fiber=cfg.fiber)
        return hm, dets

    def warm(self, shape):
        """Run the full device pipeline once on zeros of a volume geometry:
        builds the CUDA kernels, initializes cuDNN and grows the memory
        pool. run_test calls it with the header-predicted shape while the
        producer thread is still reading volume 0 from disk."""
        v = torch.zeros(tuple(int(s) for s in shape), dtype=torch.uint8,
                        device=self.device)
        _, dets = self.process(v, lo=0.0, hi=1.0)
        dets.cpu()  # drain: the next run starts clean

    def post_process(self, dets: np.ndarray, z_dim_tot: int):
        """Scale xy back to input resolution and group rows by z
        (tomo_det.py:42-51)."""
        dets = np.asarray(dets, dtype=np.float32).copy()
        dets[:, :2] *= self.config.down_ratio
        if self.z_ratio != 1:
            dets[:, 2] *= self.z_ratio
        return group_dets_by_z(dets, z_dim_tot)

    def run(self, volume, name: str = "tomo", out_dir: Optional[str] = None,
            lo: float = 0.0, hi: float = 1.0) -> Dict:
        """Full picking pipeline for one tomogram with per-stage timing."""
        hm_dev, dets, t0, t_net = self._compute(volume, lo=lo, hi=hi)
        return self._finish(hm_dev, dets, name, out_dir, t0, t_net)

    def _compute(self, volume, lo: float = 0.0, hi: float = 1.0):
        """Device half of run(): forward + decode; fetching the small (K, 5)
        table waits for the device to finish."""
        t0 = time.perf_counter()
        hm, dets = self.process(volume, lo=lo, hi=hi)
        dets = dets.cpu().numpy()
        return hm, dets, t0, time.perf_counter()

    def _finish(self, hm_dev, dets: np.ndarray, name: str,
                out_dir: Optional[str], t0: float, t_net: float) -> Dict:
        """Host half of run(): heatmap fetch, grouping, writers. Safe to run
        on a writer thread while the next volume computes (run_test does)."""
        hm_shape = tuple(hm_dev.shape)
        if self.config.write_hm:
            hm = hm_dev.cpu().numpy()  # the large heatmap device->host fetch
        else:
            hm = None
            if np.isnan(dets).any():  # keep the reference's NaN fail-fast
                raise ValueError("Output contains NaN values")
        t_fetch = time.perf_counter()
        z_dim_tot = hm_shape[0] * self.z_ratio
        z_groups = self.post_process(dets, z_dim_tot=z_dim_tot)
        t_post = time.perf_counter()
        ret = {
            "name": name,
            "hm": hm,
            "dets": dets,
            "z_groups": z_groups,
            "times": {"net+dec": t_net - t0, "fetch": t_fetch - t_net,
                      "post": t_post - t_fetch},
        }
        if out_dir is not None:
            self.save_detection(hm, z_groups, out_dir, name,
                                hm_shape=hm_shape, z_dim_tot=z_dim_tot)
            ret["times"]["save"] = time.perf_counter() - t_post
        ret["times"]["tot"] = time.perf_counter() - t0
        return ret

    # -- output writers ------------------------------------------------------

    def save_detection(self, hm: Optional[np.ndarray], z_groups: Dict,
                       path: str, name: str, hm_shape=None, z_dim_tot=None):
        """Write ``{name}_hm.mrc`` + filtered ``{name}.txt`` (tomo_det.py:53-95)."""
        rows = (c for _, rs in z_groups.items() for c in rs)
        return write_detection_outputs(self.config, hm, rows, path, name,
                                       hm_shape=hm_shape, z_dim_tot=z_dim_tot)


def write_detection_outputs(cfg, hm: Optional[np.ndarray], rows, path: str,
                            name: str, hm_shape=None, z_dim_tot=None):
    """Reference-format detection writer (tomo_det.py:53-95), a copy of the
    JAX package's: ``{name}_hm.mrc`` with y/z axes swapped + ``{name}.txt``
    after the score / cutoff_z / 20-px-border filters and the fiber/spike
    post-processing branches.

    rows: iterable of (x, y, z, score) with xy already at input resolution.
    hm may be None under --no-write_hm (pass hm_shape for the filters).
    z_dim_tot: the input-resolution z extent for the cutoff_z filter, where
    the rows' z was rescaled past the heatmap depth (res3dref decodes at
    D/2); the heatmap depth by default (detector.py:211-231).
    """
    os.makedirs(path, exist_ok=True)

    max_z, max_y, max_x = hm.shape if hm is not None else hm_shape
    max_x, max_y = max_x * cfg.down_ratio, max_y * cfg.down_ratio
    if z_dim_tot is not None:
        max_z = z_dim_tot
    if hm is not None:
        if np.isnan(hm).any():
            raise ValueError("Output contains NaN values")
        if cfg.write_hm:
            # heatmap saved with y/z axes swapped, matching the reference's
            # np.swapaxes(hm, 1, 0) before mrc write (tomo_det.py:60-67)
            write_mrc(os.path.join(path, f"{name}_hm.mrc"),
                      np.float32(np.swapaxes(hm, 1, 0)))

    lines = []
    pre_coords = []
    for c in rows:
        x, y, z = int(np.floor(c[0])), int(np.floor(c[1])), int(np.floor(c[2]))
        score = float(c[3])
        keep = (
            score > cfg.out_thresh
            and cfg.cutoff_z <= z <= max_z - cfg.cutoff_z
            and 20 < x < max_x - 20
            and 20 < y < max_y - 20
        )
        if not keep:
            continue
        if cfg.compress:
            z = z * 2
        if cfg.fiber or cfg.spike:
            pre_coords.append([x, y, z, score])
        elif cfg.with_score:
            lines.append(f"{x}\t{z}\t{y}\t{score}")
        else:
            lines.append(f"{x}\t{z}\t{y}")

    if cfg.fiber and pre_coords:
        post = fiber_postprocess(
            [c[:3] for c in pre_coords],
            distance_cutoff=cfg.distance_cutoff,
            res_cutoff=cfg.r2_cutoff,
            curvature_cutoff=cfg.curvature_cutoff,
            scale=cfg.distance_scale,
        )
        lines += [f"{c[0]}\t{c[1]}\t{c[2]}" for c in post]
    elif cfg.spike and pre_coords:
        post = spike_group_postprocess(
            pre_coords, distance_cutoff=cfg.distance_cutoff, min_per_group=5
        )
        for c in post:
            if cfg.with_score:
                lines.append(f"{int(c[0])}\t{int(c[2])}\t{int(c[1])}\t{c[3]}")
            else:
                lines.append(f"{int(c[0])}\t{int(c[2])}\t{int(c[1])}")

    with open(os.path.join(path, f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return lines


def stream_quantized_volumes(config, names, paths, device, depth: int = 2,
                             isolate_errors: bool = False):
    """Disk -> quantize -> device pipeline over a volume list.

    A producer thread reads + preprocesses tomogram i+1 while tomogram i
    computes, and ships the uint8 representation (4x fewer bytes than f32)
    with an asynchronous pinned copy (data/prefetch.py). Yields
    ``(name, device_volume_u8, lo, hi)``; use as a context manager so an
    early exit releases the producer thread. A load failure ends the
    stream with that error: what ``test`` wants for a fixed list.
    ``isolate_errors=True`` (the ``watch`` service, which must outlive one
    corrupt volume) instead yields ``(name, device_volume_u8 | None, lo,
    hi, exc | None)`` for every input, in input order: a failed load gives
    ``(name, None, 0.0, 0.0, exc)`` (detector.py:290-338). Only host-side
    failures are isolated so: an error of the card itself (a sticky CUDA
    error) ends the stream.
    """
    def produce():
        for name, path in zip(names, paths):
            try:
                vol = load_rec(path, order=config.order,
                               compress=config.compress)
                u8, lo, hi = preprocess_quantized(vol, denoise=config.gauss)
            except Exception as e:  # noqa: BLE001 — recorded per file
                if not isolate_errors:
                    raise
                yield name, None, 0.0, 0.0, e
                continue
            yield (name, u8, lo, hi, None) if isolate_errors else (
                name, u8, lo, hi)

    return PrefetchIterator(produce(), depth=depth, device=device)


def warm_from_header(det, rec_paths, config):
    """Warm ``det``'s device pipeline for volume 0's geometry (a 1 KB MRC
    header read) while the producer thread is still loading its data.
    Only an optimization: a failure (an unreadable header, absurd dims
    from a corrupt file, an allocation a bogus geometry cannot get) is
    dropped, as JAX drops it (detector.py:341-361), so that the stream's
    loader reports its own per-file error; a fault of the device path shows
    again on the first volume."""
    paths = list(rec_paths)
    if not paths:
        return
    try:
        det.warm(predict_loaded_shape(paths[0], order=config.order,
                                      compress=config.compress))
    except Exception:  # noqa: BLE001 — the loader reports it
        pass


def run_test(config, out_dir=None, device="cuda"):
    """test.py equivalent: run the detector over the test image list
    (reference cet_pick/test.py:65-93), pipelined at both ends: the producer
    thread overlaps tomogram i+1's load + device copy with tomogram i's
    forward, and a writer thread overlaps tomogram i-1's heatmap fetch +
    post-process + file writes with it too. ``--profile_dir`` traces the
    whole run (detector.py:374-401). Returns {name: stage times}."""
    set_float32_precision(config.dtype)
    il = read_image_list(os.path.join(config.data_dir, config.test_img_txt))
    det = TomoDetector(config, device=device)
    out_dir = out_dir or config.out_path
    results = {}
    errs = []
    q = queue.Queue(maxsize=2)  # bounds heatmaps held on the device

    def writer():
        while True:
            item = q.get()
            if item is None:
                return
            try:
                name, hm_dev, dets, t0, t_net = item
                r = det._finish(hm_dev, dets, name, out_dir, t0, t_net)
                print(f"{name}: " + " ".join(
                    f"{k} {v:.3f}s" for k, v in r["times"].items()
                ))
                results[name] = r["times"]
            except BaseException as e:  # surfaced after join
                errs.append(e)

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    try:
        with maybe_trace(config.profile_dir, det.device.type == "cuda"), \
                stream_quantized_volumes(config, il["image_name"],
                                         il["rec_path"], det.device) as vols:
            warm_from_header(det, il["rec_path"], config)
            for name, v_dev, lo, hi in vols:
                with annotate(f"volume {name}"):
                    hm_dev, dets, t0, t_net = det._compute(v_dev, lo=lo,
                                                           hi=hi)
                q.put((name, hm_dev, dets, t0, t_net))
                if errs:
                    break
    finally:
        q.put(None)
        w.join()
    if errs:
        raise errs[0]
    return results
