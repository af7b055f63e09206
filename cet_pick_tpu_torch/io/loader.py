"""Tomogram / tilt-series loading + preprocessing — a copy of
``cet_pick_tpu/io/loader.py:26-290``.

The numpy code is copied as it is, so that ``preprocess_quantized`` returns
byte-identical ``(u8, lo, hi)``. Semantics of reference
cet_pick/utils/loader.py:16-121:

* ``quantize``       — loader.py:16-25  (linear [mi,ma] -> uint8 with clipping)
* ``load_rec``       — loader.py:27-88  (axis reorder to (z, x, y), optional
                       z-compression by pairwise max, global standardization)
* ``preprocess``     — loader.py:90-121 (optional gaussian denoise, z-score,
                       quantize, rescale to [0, 1]; tilt series per slice)
* ``preprocess_quantized`` — the tomogram path of loader.py:90-121, keeping
                       the uint8 representation for dequantization on the
                       device
* ``QuantizedTomo`` / ``load_tomos_quantized_from_list`` — uint8-resident
                       training volumes whose crops dequantize bit-identically
* list loaders       — loader.py:134-173 (float tomograms, tilt stacks with
                       their ``.tlt`` angles; the exploration datasets)

All of this is host-side numpy: it runs once per tomogram.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from cet_pick_tpu_torch.io.mrc import read_mrc, read_mrc_shape


def quantize(x, mi=-2.5, ma=2.0, dtype=np.uint8, inplace=False):
    """Linear map [mi, ma] -> [0, 255] with clipping + rounding (loader.py:16-25).

    ``inplace=True`` (float ndarray input we own) runs the identical op
    sequence without temporaries — subtract, multiply by 255, divide, in the
    reference's order, so results are bit-identical.
    """
    if mi is None:
        mi = x.min()
    if ma is None:
        ma = x.max()
    r = ma - mi
    if inplace:
        x -= mi
        x *= 255  # (x - mi) * 255 == 255 * (x - mi) exactly
        x /= r
    else:
        x = 255 * (x - mi) / r
    np.clip(x, 0, 255, out=x)  # x is owned on both branches by now
    np.round(x, out=x)
    return x.astype(dtype)


def _standardize(x, axis=None, inplace=False):
    m = x.mean(axis=axis, keepdims=axis is not None)
    s = x.std(axis=axis, keepdims=axis is not None)
    # constant input (zero std) -> zeros instead of NaN
    s = np.where(s == 0, 1.0, s)
    if inplace:  # identical elementwise ops, no (z, x, y) temporaries
        x -= m
        x /= s
        return x
    return (x - m) / s


def predict_loaded_shape(path, order="xyz", compress=False):
    """Shape ``load_rec(path, order, compress)`` will return, from the MRC
    header alone (no data read)."""
    a0, a1, a2 = read_mrc_shape(path)  # raw (nz, ny, nx) array axes
    # mirror load_rec's axis moves on the shape tuple
    if order == "zxy":
        d, h, w = a0, a1, a2
    elif order == "xzy":  # swapaxes(2,1) then moveaxis(2, 0)
        d, h, w = a1, a0, a2
    elif order == "xyz":  # moveaxis(2, 0)
        d, h, w = a2, a0, a1
    elif order == "yxz":  # swapaxes(1,0) then moveaxis(2, 0)
        d, h, w = a2, a1, a0
    else:
        raise ValueError(f"unknown axis order {order!r}")
    if compress:
        d = (d + 1) // 2  # _compress_z: pairs max-merged, odd tail kept
    return d, h, w


def _compress_z(vol):
    """Max over consecutive z-slice pairs; odd tails keep the single slice.

    Matches loader.py:44-51 (``np.max(rec[..., i:i+2])`` for i in 0,2,...).
    """
    z = vol.shape[0]
    even = vol[: z - (z % 2)]
    out = np.maximum(even[0::2], even[1::2])
    if z % 2:
        out = np.concatenate([out, vol[-1:]], axis=0)
    return out


def load_rec(path, order="xyz", compress=False, is_tilt=False):
    """Load an MRC volume -> float array of shape (z, x, y).

    ``order`` names the semantic order of the raw array's axes. The reference
    (loader.py:27-88) reorders so the output stacks z-slices of shape (x, y):

    * ``xzy``: raw (x, z, y) -> swap axes 2,1 -> (x, y, z) -> transpose to (z, x, y)
    * ``xyz``: raw (x, y, z) -> transpose to (z, x, y)
    * ``yxz``: raw (y, x, z) -> swap axes 1,0 -> (x, y, z) -> (z, x, y)
    * ``zxy``: raw already (z, x, y)

    With ``compress``, consecutive z-slice pairs are max-merged. Tilt series
    are standardized per slice; tomograms globally.
    """
    rec = np.asarray(read_mrc(path), dtype=np.float64)
    if order in ("xzy", "xyz", "yxz"):
        if order == "xzy":
            rec = np.swapaxes(rec, 2, 1)
        elif order == "yxz":
            rec = np.swapaxes(rec, 1, 0)
        # rec is now semantically (x, y, z); stack z-slices -> (z, x, y)
        vol = np.moveaxis(rec, 2, 0)
    elif order == "zxy":
        vol = rec
    else:
        raise ValueError(f"unknown axis order {order!r}")

    if compress:
        vol = _compress_z(vol)
    vol = np.ascontiguousarray(vol)

    if is_tilt:
        vol = _standardize(vol, axis=(1, 2), inplace=True)
    else:
        vol = _standardize(vol, inplace=True)
    return vol


def _minmax01(x, axis=None, inplace=False):
    mn = x.min(axis=axis, keepdims=axis is not None)
    mx = x.max(axis=axis, keepdims=axis is not None)
    rng = np.where(mx == mn, 1.0, mx - mn)  # constant input -> zeros
    if inplace:
        x -= mn
        x /= rng
        return x
    return (x - mn) / rng


def preprocess(vol, denoise=0, is_tilt=False):
    """Standardize -> quantize to uint8 -> rescale to [0, 1] (loader.py:90-121).

    Tomograms: global statistics; ``denoise`` > 0 applies a 3D gaussian filter
    first and widens the quantization window to [-3, 3].
    Tilt series: per-slice statistics and per-slice min-max (the reference
    loops slices with cv2.normalize; equivalent to per-slice min-max to [0,1]).
    """
    # an owned float64 copy, so every later pass runs in place in the same
    # op order as JAX's
    vol = np.array(vol, dtype=np.float64)
    if is_tilt:
        if denoise > 0:
            vol = np.stack([gaussian_filter(s, sigma=denoise) for s in vol])
        vol = _standardize(vol, axis=(1, 2), inplace=True)
        vol = quantize(vol, inplace=True).astype(np.float64)
        return _minmax01(vol, axis=(1, 2), inplace=True)
    if denoise > 0:
        vol = gaussian_filter(vol, sigma=denoise)
        vol = _standardize(vol, inplace=True)
        vol = quantize(vol, mi=-3, ma=3, inplace=True).astype(np.float64)
    else:
        vol = _standardize(vol, inplace=True)
        vol = quantize(vol, inplace=True).astype(np.float64)
    return _minmax01(vol, inplace=True)


def preprocess_quantized(vol, denoise=0):
    """Tomogram preprocessing that keeps the uint8 representation.

    Returns (u8, lo, hi) such that the reference's float preprocessing
    (standardize -> quantize -> min-max to [0, 1]) equals
    ``(u8 - lo) / (hi - lo)``. Shipping the uint8 volume to the device and
    dequantizing there moves 4x fewer bytes host -> device.
    """
    vol = np.array(vol, dtype=np.float64)  # owned copy -> in-place passes
    if denoise > 0:
        vol = gaussian_filter(vol, sigma=denoise)
        vol = _standardize(vol, inplace=True)
        q = quantize(vol, mi=-3, ma=3, inplace=True)
    else:
        vol = _standardize(vol, inplace=True)
        q = quantize(vol, inplace=True)
    lo, hi = float(q.min()), float(q.max())
    return q, lo, hi


class QuantizedTomo:
    """A preprocessed tomogram kept uint8-resident in host RAM (a copy of
    ``cet_pick_tpu/io/loader.py:198-244``).

    The preprocessed volume takes only 256 distinct values — it is
    ``(q - lo) / (hi - lo)`` for the ``(q, lo, hi)`` of
    ``preprocess_quantized`` — so a training dataset holds it quantized (4x
    less host RAM than float32) and dequantizes crops on access, with the
    same float64 ops as JAX's, so crops are bit-identical.

    Supports the ndarray surface the crop datasets use: ``.shape``,
    ``.ndim``, slicing (returns a dequantized float32 array) and
    ``.astype``.
    """

    def __init__(self, u8, lo, hi):
        self.u8 = u8
        self.lo = float(lo)
        self.hi = float(hi)

    @property
    def shape(self):
        return self.u8.shape

    @property
    def ndim(self):
        return self.u8.ndim

    def _dequant(self, q):
        x = q.astype(np.float64)
        x -= self.lo
        x /= (self.hi - self.lo) or 1.0  # constant volume -> zeros
        return x.astype(np.float32)

    def __getitem__(self, idx):
        return self._dequant(self.u8[idx])

    def astype(self, dtype):
        return self._dequant(self.u8).astype(dtype, copy=False)

    def __array__(self, dtype=None, copy=None):
        out = self._dequant(self.u8)
        return out.astype(dtype, copy=False) if dtype is not None else out


def load_tomos_quantized_from_list(names, paths, order="xzy", compress=False,
                                   denoise=0):
    """Load + preprocess tomograms -> ``{name: QuantizedTomo}``
    (loader.py:247-260). Tomograms only: the tilt path normalizes per
    slice, which has no single (lo, hi)."""
    images = {}
    for name, path in zip(names, paths):
        im = load_rec(path, order=order, compress=compress, is_tilt=False)
        q, lo, hi = preprocess_quantized(im, denoise=denoise)
        images[name] = QuantizedTomo(q, lo, hi)
    return images


def load_tlt(path):
    """Read a .tlt tilt-angle file -> (n, 1) float array (loader.py:263-265)."""
    return np.loadtxt(path, ndmin=1).reshape(-1, 1)


def load_tomos_from_list(names, paths, order="xzy", compress=False,
                         denoise=0, tilt=False):
    """Load + preprocess float32 tomograms keyed by name (loader.py:268-274)."""
    images = {}
    for name, path in zip(names, paths):
        im = load_rec(path, order=order, compress=compress, is_tilt=tilt)
        images[name] = preprocess(im, denoise=denoise,
                                  is_tilt=tilt).astype(np.float32)
    return images


def load_tomo_all_and_angles_from_list(
    names, tilt_paths, rec_paths, angle_paths,
    order_tilt="zxy", order_rec="xzy", compress=False, denoise=0,
):
    """Matched tilt stacks + reconstructions + angles (loader.py:277-290).
    The axis orders are fixed, not ``--order``: the 2d3d exploration loader
    reads tilts as ``zxy`` and reconstructions as ``xzy``."""
    tilt_ims, rec_ims, angles = {}, {}, {}
    for name, tpath, rpath, apath in zip(names, tilt_paths, rec_paths,
                                         angle_paths):
        tilt_im = load_rec(tpath, order=order_tilt, compress=False,
                           is_tilt=True)
        rec_im = load_rec(rpath, order=order_rec, compress=compress,
                          is_tilt=False)
        tilt_ims[name] = preprocess(tilt_im, denoise=denoise,
                                    is_tilt=True).astype(np.float32)
        rec_ims[name] = preprocess(rec_im, denoise=denoise,
                                   is_tilt=False).astype(np.float32)
        angles[name] = load_tlt(apath)
    return tilt_ims, rec_ims, angles
