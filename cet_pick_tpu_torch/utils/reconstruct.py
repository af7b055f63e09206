"""Fourier-space voxel backprojection + amplitude-spectrum tools — port of
``cet_pick_tpu/utils/reconstruct.py`` onto ``torch`` / ``torch.fft``
(reference: cet_pick/utils/lattice.py, pose.py, backproject_voxel.py,
extract_spectrum.py, match_spectrum.py, filter_utils.py).

* ``backproject`` inserts the masked Hartley slices of a chunk of images at
  a time into flat D^3 accumulators with ``index_add_``: one launch per
  chunk and corner. JAX inserts image by image in a ``lax.scan`` with
  ``.at[].add``; its index rules are kept: a negative index wraps once, and
  a point with an index past the end is dropped. The card's atomic adds
  have no fixed order, so the sums agree with JAX's within rounding, not
  bit for bit.
* ``rad_avg`` accumulates in float64 (JAX: an f32 ``bincount``), and the
  spectrum tools' FFTs run in float64 (JAX: complex64), so that the card
  and the CPU agree and the gap to JAX is JAX's own rounding.
* ``load_spectrum`` parses the ``.tsv`` by hand (JAX reads it with pandas).

Functions take numpy arrays and a ``device`` and return numpy arrays. File
formats (pose ``.pkl`` layout, ``.tsv`` spectrum columns) are the
reference's.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.utils.geometry import (
    compute_ctf,
    fftn_center,
    ht2_center,
)

BACKPROJECT_CHUNK = 256  # images inserted per launch

# ---------------------------------------------------------------------------
# centred 3D Hartley transform (reference fft.py ihtn_center's role)
# ---------------------------------------------------------------------------


def htn_center(v):
    """Centred n-D Hartley transform: Re(F) - Im(F) of the centred FFT."""
    f = fftn_center(v)
    return (f.real - f.imag).float()


def ihtn_center(v):
    """Inverse centred Hartley transform (involution up to 1/N)."""
    f = fftn_center(v)
    return ((f.real - f.imag) / f.numel()).float()


# ---------------------------------------------------------------------------
# lattice (reference lattice.py:11-99), numpy
# ---------------------------------------------------------------------------

def lattice_coords(d: int, extent: Optional[float] = None) -> np.ndarray:
    """(D^2, 3) xyz coordinates of the centred D x D Fourier lattice: x
    fast, y slow, z = 0 (lattice.py:14-17). D must be odd."""
    assert d % 2 == 1, "lattice size must be odd"
    if extent is None:
        extent = d // 2
    grid = np.linspace(-extent, extent, d, endpoint=True, dtype=np.float32)
    yy, xx = np.meshgrid(grid, grid, indexing="ij")
    return np.stack(
        [xx.ravel(), yy.ravel(), np.zeros(d * d, np.float32)], axis=1
    )


def circular_mask(d: int, radius: int, ignore_dc: bool = True) -> np.ndarray:
    """Boolean mask restricting the lattice to a centred disc
    (lattice.py:66-77), the DC sample dropped."""
    coords = lattice_coords(d)
    extent = d // 2
    r = radius / (d // 2) * extent
    mask = (coords ** 2).sum(-1) <= r ** 2
    if ignore_dc:
        mask[d * d // 2] = False
    return mask


def translate_ht(ff, t, freqs):
    """Phase-shift Hartley-transformed images by t pixels
    (lattice.py:127-148): H'(k) = cos(2pi k.t) H(k) + sin(2pi k.t) H(-k).

    ff: (..., M) masked HT samples whose index reversal maps k -> -k; t:
    (..., 2) pixel shifts; freqs: (M, 2) cycles/pixel."""
    tfilt = 2.0 * np.pi * (t @ freqs.T)
    return torch.cos(tfilt) * ff + torch.sin(tfilt) * ff.flip(-1)


# ---------------------------------------------------------------------------
# poses (reference pose.py PoseTracker.load/save/get_pose)
# ---------------------------------------------------------------------------

def load_poses(path, n_img: int, d: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load a cryoDRGN-format pose pickle: (rots,) or (rots, trans) with
    trans in fraction-of-box units (pose.py:38-80). Returns rots (N, 3, 3)
    float32 and trans (N, 2) in pixels (or None). ``d`` is the lattice box
    the fractions scale by: for backprojection the symmetrized size, image
    box + 1 (backproject_voxel.py:89)."""
    with open(path, "rb") as f:
        poses = pickle.load(f)
    if not isinstance(poses, tuple):
        poses = (poses,)
    rots = np.asarray(poses[0], np.float32)
    assert rots.shape == (n_img, 3, 3), (
        f"rotations have shape {rots.shape}, expected ({n_img}, 3, 3)"
    )
    trans = None
    if len(poses) == 2:
        trans = np.asarray(poses[1], np.float32)
        assert trans.shape == (n_img, 2), (
            f"translations have shape {trans.shape}, expected ({n_img}, 2)"
        )
        assert np.all(trans <= 1), (
            "old pose format: translations must be fraction-of-box"
        )
        trans = trans * d
    return rots, trans


def save_poses(path, rots: np.ndarray, trans: Optional[np.ndarray] = None,
               d: Optional[int] = None):
    """Write the reference pose pickle (pose.py:82-99); trans in pixels is
    written as fraction-of-box."""
    rots = np.asarray(rots, np.float32)
    if trans is not None:
        assert d is not None, "box size d required to normalize translations"
        payload = (rots, np.asarray(trans, np.float32) / d)
    else:
        payload = (rots,)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


# ---------------------------------------------------------------------------
# backprojection (reference backproject_voxel.py)
# ---------------------------------------------------------------------------

def symmetrize_ht(ht):
    """(..., D, D) -> (..., D+1, D+1): append the wrapped Nyquist row and
    column so the Hartley lattice is symmetric around DC."""
    d = ht.shape[-1]
    out = ht.new_zeros(ht.shape[:-2] + (d + 1, d + 1))
    out[..., :-1, :-1] = ht
    out[..., -1, :] = out[..., 0, :]
    out[..., :, -1] = out[..., :, 0]
    return out


def _norm3(d):
    """The f32 length of (..., 3) vectors, rounded as JAX's
    ``jnp.linalg.norm`` and torch's CPU ``vector_norm`` round it,
    sqrt(fma(z, z, fma(y, y, x * x))), on any device: each fma as one
    float64 sum (the products are exact there) rounded to f32, and the
    square root in float64 rounded to f32 (correctly rounded; torch's f32
    ``sqrt`` on the CPU is not). A weight 1 - |d| that rounds to 0 on one
    device and to 1e-8 on another would give a voxel that only it touches
    the sample's whole value."""
    x, y, z = (d[..., i].double() for i in range(3))
    acc = (x * x).float().double()
    acc = (y * y + acc).float().double()
    return torch.sqrt((z * z + acc).float().double()).float()


def _insert(vol, counts, f, rots, coords, d_half):
    """Add a chunk of masked slices f (B, M) at rotations rots (B, 3, 3)
    into the flat D^3 accumulators: eight corners, weight 1 - the distance
    to the corner, clipped at 0 (backproject_voxel.py:44-62), with JAX's
    scatter index rules (a negative index wraps once; a point with an index
    outside [0, D) after that is dropped)."""
    size = 2 * d_half + 1
    # (B, M, 3) xyz: the product term by term in a fixed order, so that the
    # card and the CPU round it alike (a point moved off a lattice plane
    # changes its corners)
    pts = sum(coords[None, :, k, None] * rots[:, None, k, :]
              for k in range(3))
    lo, hi = torch.floor(pts), torch.ceil(pts)
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                corner = torch.stack([(hi if c else lo)[..., a]
                                      for a, c in enumerate((cx, cy, cz))],
                                     dim=-1)
                w = torch.clamp(1.0 - _norm3(corner - pts), min=0.0)
                idx = corner.to(torch.int64) + d_half
                idx = torch.where(idx < 0, idx + size, idx)
                keep = ((idx >= 0) & (idx < size)).all(-1)
                flat = (idx[..., 2] * size + idx[..., 1]) * size + idx[..., 0]
                flat = torch.where(keep, flat, 0).reshape(-1)
                w = torch.where(keep, w, 0.0)
                vol.index_add_(0, flat, (w * f).reshape(-1))
                counts.index_add_(0, flat, w.reshape(-1))


def backproject(images, rots, trans=None, ctf_params=None, tilt_images=None,
                tilt_deg=45.0, device="cuda", chunk=BACKPROJECT_CHUNK):
    """Weighted Fourier (Hartley) voxel backprojection of a particle stack
    (reconstruct.py:165-292).

    images: (N, d, d) real-space particles (d even); rots: (N, 3, 3);
    trans: optional (N, 2) pixel shifts; ctf_params: optional (N, 9) rows of
    [Apix, dfu, dfv, dfang, volt, cs, w, phase_shift, bfactor] for CTF
    phase flipping; tilt_images: optional (N, d, d) tilt-pair stack inserted
    at the extra right-handed x-axis rotation ``tilt_deg`` on top of each
    pose, with its mate's CTF sign and translation.

    Returns the (d, d, d) real-space reconstruction (numpy float32)."""
    device = resolve_device(device)
    images = np.asarray(images, np.float32)
    n, d, d2_ = images.shape
    assert d == d2_ and d % 2 == 0, "images must be square with even box size"
    D = d + 1
    d_half = D // 2

    mask_np = circular_mask(D, d_half)
    mask = torch.from_numpy(mask_np).to(device)
    coords = torch.from_numpy(lattice_coords(D)[mask_np]).to(device)  # (M, 3)
    freqs = coords[:, :2] / d_half / 2.0              # cycles/pixel

    def masked_ht(stack):
        ht = symmetrize_ht(ht2_center(torch.from_numpy(
            np.asarray(stack, np.float32)).to(device)))
        return ht.reshape(len(stack), -1)[:, mask]    # (N, M)

    ff = masked_ht(images)
    sign = None
    if ctf_params is not None:
        p = torch.from_numpy(np.asarray(ctf_params, np.float32)).to(device)
        c = compute_ctf(freqs[None] / p[:, 0, None, None],
                        *(p[:, i, None] for i in range(1, 8)))
        sign = torch.sign(c)
        ff = ff * sign
    t_all = None if trans is None else \
        torch.from_numpy(np.asarray(trans, np.float32)).to(device)

    rots = np.asarray(rots, np.float32)
    passes = [(ff, rots)]
    if tilt_images is not None:
        assert np.asarray(tilt_images).shape == images.shape, (
            "tilt stack must match the particle stack shape"
        )
        t = np.deg2rad(tilt_deg)
        xrot = np.array([[1, 0, 0],
                         [0, np.cos(t), -np.sin(t)],
                         [0, np.sin(t), np.cos(t)]], np.float32)
        ff_tilt = masked_ht(tilt_images)
        if sign is not None:
            ff_tilt = ff_tilt * sign
        # the (N, 3, 3) product on the host, as JAX forms it: a one-ulp
        # change moves a point that sits on a lattice plane off it, and
        # changes its corners
        passes.append((ff_tilt, xrot @ rots))

    vol = torch.zeros(D ** 3, dtype=torch.float32, device=device)
    counts = torch.zeros(D ** 3, dtype=torch.float32, device=device)
    for ff_pass, rmats in passes:
        for i in range(0, n, chunk):
            f = ff_pass[i:i + chunk]
            if t_all is not None:
                f = translate_ht(f, t_all[i:i + chunk], freqs)
            _insert(vol, counts, f, torch.from_numpy(
                rmats[i:i + chunk]).to(device), coords, d_half)
    counts = torch.where(counts == 0, 1.0, counts)
    vol = (vol / counts).reshape(D, D, D)
    return ihtn_center(vol[:-1, :-1, :-1]).cpu().numpy()


# ---------------------------------------------------------------------------
# amplitude spectrum tools (reference extract_spectrum.py / match_spectrum.py
# / filter_utils.py)
# ---------------------------------------------------------------------------

def _rad_bins(shape, device):
    """Integer radial bin per voxel (filter_utils.py:65-75: every axis is
    offset by max(shape)/2, and there are max(shape)/2 bins), in float64 as
    numpy computes it."""
    m = max(shape)
    axes = [(torch.arange(s, dtype=torch.float64, device=device) - m * 0.5)
            .reshape([-1 if i == j else 1 for j in range(len(shape))])
            for i, s in enumerate(shape)]
    r2 = 0
    for a in axes:
        r2 = r2 + a ** 2
    r = torch.sqrt(r2)
    return (m / 2 * r / r.max()).to(torch.int32)


def _rad_avg(image):
    """rad_avg of a tensor: float64 sums, NaN for an empty bin."""
    rbin = _rad_bins(image.shape, image.device).reshape(-1).to(torch.int64)
    length = int(rbin.max()) + 1
    sums = torch.zeros(length, dtype=torch.float64, device=image.device)
    sums.index_add_(0, rbin, image.reshape(-1).to(torch.float64))
    cnts = torch.bincount(rbin, minlength=length)
    out = sums[1:] / cnts[1:].clamp_min(1)
    return torch.where(cnts[1:] == 0, torch.nan, out)


def rad_avg(image, device="cuda") -> np.ndarray:
    """Radially averaged intensity (reconstruct.py:308-320); bin 0 (the
    exact centre) is dropped like the reference's index=arange(1, ...), and
    an empty bin is NaN, as ndimage.mean gives. float32, as JAX's."""
    image = torch.as_tensor(np.asarray(image), device=resolve_device(device))
    return _rad_avg(image).float().cpu().numpy()


def _normalized_fft(tomo, device):
    """fftshift(fftn()) of the min-max normalized volume: the normalization
    in f32 as JAX's, the transform in float64 (JAX: complex64), so that
    the card and the CPU agree within 1e-5 per radial bin of a 256x512x512
    volume, where two f32 FFTs lie up to 2e-5 apart."""
    t = torch.from_numpy(np.asarray(tomo, np.float32)).to(
        resolve_device(device))
    t = t - t.min()
    t = t / t.max()
    return torch.fft.fftshift(torch.fft.fftn(t.double()))


def extract_spectrum(tomo, device="cuda") -> np.ndarray:
    """Radially averaged amplitude spectrum of a (min-max normalized)
    volume (extract_spectrum.py:9-21)."""
    return _rad_avg(torch.abs(_normalized_fft(tomo, device))).float() \
        .cpu().numpy()


def save_spectrum(path, spectrum: np.ndarray):
    """Write the reference .tsv: freq\\tintensity with a header
    (extract_spectrum.py:33)."""
    with open(path, "w") as f:
        f.write("freq\tintensity\n")
        for i, v in enumerate(np.asarray(spectrum)):
            f.write(f"{i}\t{v}\n")


def load_spectrum(path) -> np.ndarray:
    """The ``intensity`` column of a spectrum ``.tsv`` as float64 (JAX reads
    it with pandas; ``nan`` reads as NaN there and here)."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        col = header.index("intensity")
        return np.array([float(line.rstrip("\n").split("\t")[col])
                         for line in f if line.strip()], np.float64)


def _axis_dist(s: int) -> np.ndarray:
    """Mirrored per-axis distance vector of the reference's octant-then-pad
    kernel (filter_utils.py:78-93): odd axes reflect (|i-(s-1)/2|), even
    axes duplicate the edge (|i-(s-1)/2| - 1/2)."""
    i = np.arange(s, dtype=np.float32)
    d = np.abs(i - (s - 1) / 2.0)
    return d if s % 2 else d - 0.5


def _interp(x, fp):
    """``jnp.interp(x, arange(n), fp)`` for x in [0, n - 1]: the segment
    from ``searchsorted(side='right')`` clipped to [1, n - 1]."""
    n = fp.shape[0]
    i = torch.clamp(torch.floor(x).to(torch.int64) + 1, 1, n - 1)
    lo = fp[i - 1]
    return lo + (x - (i - 1).to(x.dtype)) * (fp[i] - lo)


def equalization_kernel(equal_v, shape, device="cuda"):
    """Radial kernel: the per-bin gains interpolated onto every voxel's
    radius, zero beyond the last bin (filter_utils.py:78-93 rot_kernel).
    A tensor of ``shape``."""
    device = resolve_device(device)
    r2 = 0
    for i, s in enumerate(shape):
        a = torch.from_numpy(_axis_dist(s)).to(device)
        shape_i = [-1 if i == j else 1 for j in range(len(shape))]
        r2 = r2 + a.reshape(shape_i) ** 2
    r = torch.sqrt(r2)
    gains = torch.as_tensor(np.asarray(equal_v, np.float32), device=device)
    n = len(equal_v)
    k = _interp(torch.clamp(r, max=float(n - 1)), gains)
    return torch.where(r > n - 1, 0.0, k)


def match_spectrum(tomo, target_spectrum, cutoff: Optional[int] = None,
                   smooth: float = 0.0, device="cuda") -> np.ndarray:
    """Filter ``tomo`` so its radial amplitude spectrum matches
    ``target_spectrum`` (match_spectrum.py:12-51): per-bin gain
    target/input, the target zero-padded or truncated to the input's bins,
    an optional low-pass (hard, or a sigmoid of width ~``smooth`` bins),
    applied as one FFT multiply on the device."""
    t = _normalized_fft(tomo, device)
    input_spectrum = _rad_avg(torch.abs(t)).float().cpu().numpy()
    target = np.asarray(target_spectrum, np.float64).copy()
    target.resize(len(input_spectrum))  # zero-pad / truncate in place
    equal_v = target / np.asarray(input_spectrum, np.float64)

    if cutoff:
        n = len(equal_v)
        if smooth:
            slope = n / smooth
            offset = 2 * slope * ((cutoff - n / 2) / n)
            cutoff_v = 1.0 / (1.0 + np.exp(np.linspace(-slope, slope, n)
                                           - offset))
        else:
            cutoff_v = np.ones_like(equal_v)
            equal_v[cutoff:] = 0
        equal_v = equal_v * cutoff_v

    kernel = equalization_kernel(np.asarray(equal_v, np.float32), t.shape,
                                 device=t.device)
    out = torch.abs(torch.fft.ifftn(t * kernel.double()))
    return out.float().cpu().numpy()
