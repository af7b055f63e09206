"""3D tomogram overlay volumes for napari — port of
``cet_pick_tpu/viz/tomo3d.py`` (reference cet_pick/visualize_3dhm.py:110-149).

For each tomogram: (a) an RGB uint8 copy of the reconstruction (each slice
standardized, quantized to [-3σ, 3σ], lightly gaussian-smoothed) saved as
``{name}_rec3d.npy``, and (b) an empty RGB volume with a filled circle of the
particle's embedding color at each detection, its radius shrinking with the
z-distance from the particle's centre (12 - |dz|, dz in ±2), saved as
``{name}_hm3d_simsiam.npy``. Host code (OpenCV, SciPy); the arrays are the
JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from cet_pick_tpu_torch.viz import require


def _quantize(x, mi=-3, ma=3):
    """io.loader.quantize at the viz scripts' [-3, 3] window (the reference
    scripts quantize thumbnails/overlays at 3 sigma, plot_2d.py:95)."""
    from cet_pick_tpu_torch.io.loader import quantize

    return quantize(x, mi=mi, ma=ma)


def render_3d_hm(volume, coords, colors, names, use_name, out_dir):
    """Paint per-particle colored spheres aligned with the tomogram
    (visualize_3dhm.py:110-149). coords rows (x, y, z); colors (N, 3)
    uint8. Returns the two paths, or (None, None) where ``use_name`` has no
    coordinates."""
    cv2 = require("cv2", "visualize3d")
    gaussian_filter = require("scipy.ndimage", "visualize3d").gaussian_filter

    os.makedirs(out_dir, exist_ok=True)
    z_dim, r1, c1 = volume.shape
    sel = np.where(np.asarray(names) == use_name)[0]
    if len(sel) == 0:
        print(f"skipping 3D visualization for {use_name}: no coordinates")
        return None, None
    coords = np.asarray(coords)[sel]
    colors = np.asarray(colors)[sel]

    rec_all = np.zeros((z_dim, r1, c1, 3), dtype=np.uint8)
    for i in range(z_dim):
        s = volume[i].astype(np.float64)
        s = (s - s.mean()) / max(s.std(), 1e-12)
        q = _quantize(s)
        rec_all[i] = np.dstack((q, q, q))
    rec_all = gaussian_filter(rec_all, sigma=0.8)
    rec_path = os.path.join(out_dir, f"{use_name}_rec3d.npy")
    np.save(rec_path, rec_all)

    hm_all = np.zeros((z_dim, r1, c1, 3), dtype=np.uint8)
    for slice_num in np.unique(coords[:, -1]):
        hm = np.zeros((r1, c1, 3), np.uint8)
        band = np.abs(coords[:, -1] - slice_num) <= 2
        for c, color in zip(coords[band], colors[band]):
            radius = int(12 - abs(c[-1] - slice_num))
            cv2.circle(hm, (int(c[0]), int(c[1])), radius,
                       (int(color[0]), int(color[1]), int(color[2])), -1)
        zi = int(slice_num)
        if 0 <= zi < z_dim:
            hm_all[zi] = hm
    hm_path = os.path.join(out_dir, f"{use_name}_hm3d_simsiam.npy")
    np.save(hm_path, hm_all)
    return rec_path, hm_path
