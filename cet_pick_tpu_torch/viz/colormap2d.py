"""Procedural 2D colormaps for embedding visualization — a copy of
``cet_pick_tpu/viz/colormap2d.py`` (numpy only), so that ``all_colors.npy``
and the plots' colors are the JAX package's byte for byte.

The reference vendors pycolormap_2d's pre-baked .npy LUTs (Bremm, Ziegler,
Steiger, Schumann; reference cet_pick/colormap/colormap_2d.py:17-87 +
colormap/data/*.npy) and samples them bilinearly. Rather than copying binary
LUT files, each map here is *generated* from its published corner-color
design (the four corners of the unit square blended bilinearly, optionally
with a center anchor), which reproduces the visual intent: every (x, y) in
the unit square gets a distinct, smoothly varying RGB so 2D embedding
position is readable as color in the 3D tomogram overlay.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# corner colors (bottom-left, bottom-right, top-left, top-right [, center])
_PALETTES: Dict[str, Tuple] = {
    # teal / yellow / blue / red, light center — Ziegler-style
    "ziegler": ((0, 160, 160), (230, 220, 40), (40, 60, 230), (220, 40, 60),
                (235, 235, 235)),
    # green / yellow / blue / pink — Bremm-style
    "bremm": ((60, 180, 75), (255, 225, 25), (0, 90, 200), (240, 80, 180),
              None),
    # cyan / green / blue / magenta-red — Steiger-style
    "steiger": ((90, 200, 210), (120, 200, 80), (50, 70, 180), (200, 60, 90),
                None),
    # light blue / olive / purple / orange — Schumann-style
    "schumann": ((150, 200, 240), (160, 160, 60), (120, 60, 160), (240, 150, 60),
                 (220, 220, 220)),
}


class ColorMap2D:
    """Bilinear 2D colormap over the unit square -> RGB uint8."""

    def __init__(self, name: str = "ziegler", resolution: int = 256,
                 range_x=(0.0, 1.0), range_y=(0.0, 1.0)):
        if name not in _PALETTES:
            raise ValueError(f"unknown 2D colormap {name!r}; have {sorted(_PALETTES)}")
        bl, br, tl, tr, center = _PALETTES[name]
        self.range_x = range_x
        self.range_y = range_y
        r = resolution
        u = np.linspace(0, 1, r)[None, :, None]   # x
        v = np.linspace(0, 1, r)[:, None, None]   # y
        bl, br, tl, tr = (np.asarray(c, np.float64) for c in (bl, br, tl, tr))
        lut = ((1 - u) * (1 - v) * bl + u * (1 - v) * br
               + (1 - u) * v * tl + u * v * tr)
        if center is not None:
            c = np.asarray(center, np.float64)
            # radial pull toward the center color, strongest mid-square
            w = np.exp(-(((u - 0.5) ** 2 + (v - 0.5) ** 2) / 0.08))
            lut = (1 - 0.5 * w) * lut + 0.5 * w * c
        self.lut = np.clip(np.round(lut), 0, 255).astype(np.uint8)

    def sample(self, x: float, y: float) -> np.ndarray:
        """Sample at (x, y) within range_x/range_y -> (3,) uint8."""
        r = self.lut.shape[0]
        fx = (x - self.range_x[0]) / (self.range_x[1] - self.range_x[0])
        fy = (y - self.range_y[0]) / (self.range_y[1] - self.range_y[0])
        i = int(np.clip(round(fy * (r - 1)), 0, r - 1))
        j = int(np.clip(round(fx * (r - 1)), 0, r - 1))
        return self.lut[i, j]

    def __call__(self, x, y):
        return self.sample(x, y)

    def sample_many(self, xy: np.ndarray) -> np.ndarray:
        """xy (N, 2) in range -> (N, 3) uint8."""
        r = self.lut.shape[0]
        fx = (xy[:, 0] - self.range_x[0]) / (self.range_x[1] - self.range_x[0])
        fy = (xy[:, 1] - self.range_y[0]) / (self.range_y[1] - self.range_y[0])
        i = np.clip(np.round(fy * (r - 1)).astype(int), 0, r - 1)
        j = np.clip(np.round(fx * (r - 1)).astype(int), 0, r - 1)
        return self.lut[i, j]
