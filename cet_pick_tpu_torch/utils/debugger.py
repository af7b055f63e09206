"""Visual debug artifacts: per-slice heatmap overlays and detection circles
— a copy of ``cet_pick_tpu/utils/debugger.py`` with no matplotlib or
OpenCV.

During validation with ``--debug > 0`` the trainer writes, every 4th z
slice of each validation volume, the predicted heatmap color-mapped and
blended onto the input slice (``pred_z*.png``), the ground-truth heatmap's
blend (``gt_z*.png``) and, where the decode has detections on the slice,
circles around them (``det_z*.png``), plus the detection txt: the
reference's QC channel (reference cet_pick/utils/debugger.py:36-99,
trains/tomo_cr_semi_trainer.py:123-187). The JAX package draws them with
``matplotlib.cm.jet``, ``cv2.circle`` and ``plt.imsave``; here the same
pixels come from numpy, ``zlib`` and ``struct``: matplotlib's ``jet`` lookup
table built from its segment data, OpenCV's thickness-1 circle (its
``Circle`` routine, drawing.cpp) and an 8-bit RGBA PNG writer.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# matplotlib's jet (matplotlib/_cm.py ``_jet_data``): per channel, rows
# (x, value below x, value above x)
_JET = {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
                  (0.91, 0, 0), (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
                 (1.0, 0, 0))}
_N = 256  # matplotlib's default colormap size (rcParams["image.lut"])


def _lookup_table(data, n=_N):
    """matplotlib's ``_create_lookup_table`` (colors.py) for segment data
    ``data`` at ``n`` entries, gamma 1."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_table():
    """The (n, 3) RGB table ``matplotlib.cm.jet`` indexes, float64."""
    return np.stack([_lookup_table(_JET[c]) for c in ("red", "green",
                                                      "blue")], axis=1)


_JET_LUT = jet_table()


def jet(x):
    """RGB float64 of ``cm.jet(x)[..., :3]`` for floats in [0, 1]:
    ``floor(x * 256)`` in x's own dtype, 1.0 in the last bin, NaN black
    (matplotlib's bad color)."""
    xa = np.array(x, copy=True)
    xa *= _N
    xa[xa == _N] = _N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(xa.astype(int), 0, _N - 1)
    rgb = _JET_LUT[idx]
    rgb[bad] = 0.0
    return rgb


def _norm01(x):
    lo, hi = float(np.min(x)), float(np.max(x))
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def gen_colormap(hm_slice):
    """Heatmap slice -> RGB uint8 through jet (debugger.py:22-30)."""
    return (jet(np.clip(hm_slice, 0, 1)) * 255).astype(np.uint8)


def blend(img_slice, hm_slice, alpha=0.5):
    """A grayscale slice blended with its color-mapped heatmap
    (debugger.py:33-38)."""
    g = (_norm01(img_slice) * 255).astype(np.uint8)
    base = np.dstack([g, g, g])
    overlay = gen_colormap(hm_slice)
    return (alpha * base + (1 - alpha) * overlay).astype(np.uint8)


def circle_points(cx, cy, radius):
    """The pixels (x, y) that OpenCV's ``Circle`` (drawing.cpp; what
    ``cv2.circle`` draws at thickness 1, LINE_8, no shift) sets, before
    clipping: a midpoint walk of one octant mirrored eight ways."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    pts = []
    while dx >= dy:
        pts += [(cx - dx, cy - dy), (cx - dx, cy + dy), (cx + dx, cy - dy),
                (cx + dx, cy + dy), (cx - dy, cy - dx), (cx - dy, cy + dx),
                (cx + dy, cy - dx), (cx + dy, cy + dx)]
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.array(pts, dtype=np.int64)


def draw_circle(canvas, center, radius, color):
    """``cv2.circle(canvas, center, radius, color, 1)`` on an (H, W, C)
    uint8 canvas, in place: the points inside the canvas."""
    h, w = canvas.shape[:2]
    p = circle_points(int(center[0]), int(center[1]), int(radius))
    keep = (p[:, 0] >= 0) & (p[:, 0] < w) & (p[:, 1] >= 0) & (p[:, 1] < h)
    canvas[p[keep, 1], p[keep, 0]] = color
    return canvas


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img):
    """An 8-bit RGBA PNG of an (H, W, 3) or (H, W, 4) uint8 image: the
    pixels ``plt.imsave`` writes for it (RGB gets alpha 255); the bytes
    differ, as matplotlib adds its own text and pHYs chunks."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"png_bytes wants (H, W, 3|4) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], 2)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 4)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(png_bytes(img))


class Debugger:
    """Accumulates the debug images of one validation volume and saves
    them as PNGs (debugger.py:41-99)."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.imgs = {}

    def add_blend(self, name, img_slice, hm_slice):
        self.imgs[name] = blend(img_slice, hm_slice)

    def add_detections(self, name, img_slice, dets, radius=8,
                       color=(255, 0, 0)):
        """Circles around detections (rows x, y[, ...]) on a slice."""
        g = (_norm01(img_slice) * 255).astype(np.uint8)
        canvas = np.dstack([g, g, g])
        for d in dets:
            draw_circle(canvas, (int(d[0]), int(d[1])), radius, color)
        self.imgs[name] = canvas

    def save_all(self, prefix=""):
        """Write the accumulated images; returns their paths."""
        paths = []
        for name, img in self.imgs.items():
            p = os.path.join(self.out_dir, f"{prefix}{name}.png")
            write_png(p, img)
            paths.append(p)
        return paths

    def save_detection_txt(self, name, dets, down_ratio=2, with_score=True):
        """The detection table txt, ``x\\tz\\ty[\\tscore]`` at input
        resolution (debugger.py:73-88)."""
        p = os.path.join(self.out_dir, f"{name}.txt")
        with open(p, "w") as f:
            for d in dets:
                x, y, z = (int(d[0]) * down_ratio, int(d[1]) * down_ratio,
                           int(d[2]))
                row = [str(x), str(z), str(y)] + (
                    [f"{float(d[3]):.4f}"] if with_score and len(d) > 3
                    else [])
                f.write("\t".join(row) + "\n")
        return p


def debug_validation_volume(debugger, volume, pred_hm, gt_hm, dets=None,
                            every=4):
    """Per-slice debug dump of a validation volume
    (tomo_cr_semi_trainer.py:123-187): every ``every``-th z, the blends of
    the predicted and the ground-truth heatmaps, and the detections of that
    slice where there are any. ``volume`` (D, H, W) at input resolution,
    ``pred_hm`` / ``gt_hm`` (D, H', W') at heatmap resolution."""
    d = pred_hm.shape[0]
    for z in range(0, d, every):
        img = volume[z, ::2, ::2] if volume.shape[1] != pred_hm.shape[1] \
            else volume[z]
        debugger.add_blend(f"pred_z{z:03d}", img, pred_hm[z])
        debugger.add_blend(f"gt_z{z:03d}", img, np.clip(gt_hm[z], 0, 1))
        if dets is not None:
            zdets = [row for row in dets if int(row[2]) == z]
            if zdets:
                debugger.add_detections(f"det_z{z:03d}", img, zdets)
    return debugger.save_all()
