"""Volume geometry toolbox: SO(3) sampling, rotation/projection, FFT, CTF —
port of ``cet_pick_tpu/utils/geometry.py`` onto ``torch`` / ``torch.fft``
(reference: cet_pick/utils/lie_tools.py, project3d.py, fft.py, ctf.py,
so3_grid.py):

* ``random_quaternions`` / ``random_so3`` / ``constrained_so3`` /
  ``grid_SO3`` — rotation sampling, numpy, as JAX draws it
  (lie_tools.py:137-166)
* ``Projector`` — real-space volume rotation by trilinear resampling on the
  centred ``linspace(-1, 1, d)`` lattice + projection (z-sum)
  (project3d.py:48-97), on the device, many rotations per call
* ``fft2_center`` / ``ifft2_center`` / ``ht2_center`` / ``iht2_center`` /
  ``fftn_center`` / ``ifftn_center`` — centred FFT / Hartley transforms
  (fft.py)
* ``compute_ctf`` — 2D CTF with astigmatism, phase shift and B-factor
  envelope (ctf.py:6-39)
* ``fsc`` / ``fsc_resolution`` / ``ctf_freqs``

JAX resamples with ``jax.scipy.ndimage.map_coordinates(order=1,
mode="constant", cval=0)``: each of the eight corners outside ``[0, d-1]``
contributes 0. ``grid_sample(align_corners=True, padding_mode="zeros")``
has the same corner rule, and ``align_corners=True`` maps -1 and 1 onto
the first and last voxel centres, JAX's ``(x + 1) * (d - 1) / 2``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def random_quaternions(n, rng: np.random.Generator):
    """Uniform unit quaternions (Shoemake; lie_tools.py:137-144)."""
    u1, u2, u3 = rng.random((3, n))
    return np.stack([
        np.sqrt(1 - u1) * np.sin(2 * np.pi * u2),
        np.sqrt(1 - u1) * np.cos(2 * np.pi * u2),
        np.sqrt(u1) * np.sin(2 * np.pi * u3),
        np.sqrt(u1) * np.cos(2 * np.pi * u3),
    ], axis=1)


def quaternions_to_so3(q):
    """Unit quaternion(s) (N, 4) -> rotation matrices (N, 3, 3)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def random_so3(n, rng: np.random.Generator):
    """n uniform rotation matrices (lie_tools.py:165-166)."""
    return quaternions_to_so3(random_quaternions(n, rng))


def constrained_so3(rng: np.random.Generator):
    """Small near-identity rotation (lie_tools.py:146-163): the first two
    Shoemake parameters are squeezed into [0, 0.1]."""
    u = rng.random(3)
    u[0] = u[0] * 0.1
    u[1] = u[1] * 0.1
    q = np.array([
        np.sqrt(1 - u[0]) * np.sin(2 * np.pi * u[1]),
        np.sqrt(1 - u[0]) * np.cos(2 * np.pi * u[1]),
        np.sqrt(u[0]) * np.sin(2 * np.pi * u[2]),
        np.sqrt(u[0]) * np.cos(2 * np.pi * u[2]),
    ])
    return quaternions_to_so3(q[None])[0]


def grid_SO3(resol: int):
    """Quasi-uniform SO(3) rotation grid with ~(4^resol * 72) elements."""
    n_side = 2 ** resol
    thetas = np.arccos(np.linspace(1, -1, 2 * n_side + 2)[1:-1])
    phis = np.linspace(0, 2 * np.pi, 4 * n_side, endpoint=False)
    psis = np.linspace(0, 2 * np.pi, 6 * n_side, endpoint=False)
    quats = []
    for t in thetas:
        for p in phis:
            for s in psis:
                quats.append([
                    np.cos(t / 2) * np.cos(s / 2),
                    np.cos(t / 2) * np.sin(s / 2),
                    np.sin(t / 2) * np.cos(p + s / 2),
                    np.sin(t / 2) * np.sin(p + s / 2),
                ])
    return quaternions_to_so3(np.asarray(quats))


# ---------------------------------------------------------------------------
# real-space rotation + projection
# ---------------------------------------------------------------------------

def _lattice(d, device):
    """(d^3, 3) xyz points of the [-1, 1] lattice, z slowest
    (geometry.py:105-108)."""
    c = torch.linspace(-1.0, 1.0, d, device=device)
    zz, yy, xx = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)


def rotate_volumes(vol, rots):
    """Trilinear resamples of vol (D, D, D) under each rotation of rots
    (B, 3, 3) about the centre (geometry.py:100-116): (B, D, D, D). The
    rotations ride the grid's depth axis of one ``grid_sample`` call."""
    d = vol.shape[0]
    src = _lattice(d, vol.device) @ rots          # (B, d^3, 3) xyz
    grid = src.reshape(1, -1, d, d, 3)            # (1, B*d, d, d, xyz)
    out = F.grid_sample(vol[None, None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.reshape(-1, d, d, d)


class Projector:
    """Real-space rotate + project (z-sum) of a cubic volume
    (project3d.py:48-97), on ``device``."""

    def __init__(self, vol, device="cuda"):
        vol = np.asarray(vol, np.float32)
        assert vol.ndim == 3 and len(set(vol.shape)) == 1, "volume must be cubic"
        self.vol = torch.from_numpy(vol).to(device)

    def _rots(self, rot):
        return torch.as_tensor(np.asarray(rot, np.float32),
                               device=self.vol.device)

    def rotate(self, rot):
        """rot (3, 3) -> (D, D, D); (B, 3, 3) -> (B, D, D, D)."""
        r = self._rots(rot)
        out = rotate_volumes(self.vol, r.reshape(-1, 3, 3))
        return out if r.ndim == 3 else out[0]

    def project(self, rot, chunk=16):
        """rot (3, 3) -> (D, D); (B, 3, 3) -> (B, D, D), ``chunk``
        rotations per resample."""
        r = self._rots(rot)
        rr = r.reshape(-1, 3, 3)
        out = torch.cat([rotate_volumes(self.vol, rr[i:i + chunk]).sum(dim=1)
                         for i in range(0, len(rr), chunk)])
        return out if r.ndim == 3 else out[0]


# ---------------------------------------------------------------------------
# centred FFT / Hartley (fft.py); inputs are tensors, or numpy arrays taken
# to the CPU
# ---------------------------------------------------------------------------

_XY = (-2, -1)


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def fft2_center(img):
    img = _t(img)
    return torch.fft.fftshift(torch.fft.fft2(torch.fft.fftshift(img, dim=_XY)),
                              dim=_XY)


def ifft2_center(img):
    img = _t(img)
    return torch.fft.ifftshift(
        torch.fft.ifft2(torch.fft.ifftshift(img, dim=_XY)), dim=_XY)


def ht2_center(img):
    f = fft2_center(img)
    return (f.real - f.imag).float()


def iht2_center(img):
    f = fft2_center(img)
    f = f / (f.shape[-1] * f.shape[-2])
    return (f.real - f.imag).float()


def fftn_center(v):
    v = _t(v)
    return torch.fft.fftshift(torch.fft.fftn(torch.fft.fftshift(v)))


def ifftn_center(v):
    v = _t(v)
    return torch.fft.ifftshift(torch.fft.ifftn(torch.fft.ifftshift(v)))


# ---------------------------------------------------------------------------
# CTF (ctf.py:6-39)
# ---------------------------------------------------------------------------

def compute_ctf(freqs, dfu, dfv, dfang, volt, cs, w, phase_shift=0.0,
                bfactor=None):
    """2D CTF. freqs: (..., 2) spatial frequencies (1/A); dfu/dfv defocus
    (A); dfang astigmatism angle (deg); volt (kV); cs (mm); w amplitude
    contrast. The parameters are numbers or tensors that broadcast against
    ``freqs[..., 0]``."""
    freqs = _t(freqs)
    # a number stays a Python number until it meets a tensor, as JAX keeps
    # it weakly typed
    volt = volt * 1000.0
    cs = cs * 1e7
    dfang = dfang * np.pi / 180.0
    phase_shift = phase_shift * np.pi / 180.0
    lam = 12.2639 / torch.sqrt(torch.as_tensor(
        volt + 0.97845e-6 * volt ** 2, dtype=freqs.dtype,
        device=freqs.device))
    x, y = freqs[..., 0], freqs[..., 1]
    ang = torch.atan2(y, x)
    s2 = x ** 2 + y ** 2
    df = 0.5 * (dfu + dfv + (dfu - dfv) * torch.cos(2 * (ang - dfang)))
    gamma = 2 * np.pi * (-0.5 * df * lam * s2
                         + 0.25 * cs * lam ** 3 * s2 ** 2) - phase_shift
    ctf = (1 - w ** 2) ** 0.5 * torch.sin(gamma) - w * torch.cos(gamma)
    if bfactor is not None:
        ctf = ctf * torch.exp(-bfactor / 4 * s2)
    return ctf


def fsc(vol1, vol2):
    """Fourier shell correlation between two cubic volumes (utils/fsc.py's
    role). Returns (shell_radii_fractional, correlations), numpy."""
    vol1, vol2 = _t(vol1), _t(vol2)
    d = vol1.shape[0]
    f1 = fftn_center(vol1).to(torch.complex128)
    f2 = fftn_center(vol2).to(torch.complex128)
    coords = torch.arange(d, device=vol1.device) - d // 2
    zz, yy, xx = torch.meshgrid(coords, coords, coords, indexing="ij")
    r = torch.sqrt((xx ** 2 + yy ** 2 + zz ** 2).double())
    shells = np.arange(1, d // 2)
    corr = np.zeros(len(shells))
    prev = 0.5
    for i, s in enumerate(shells):
        mask = (r >= prev) & (r < s + 0.5)
        a, b = f1[mask], f2[mask]
        num = float(torch.vdot(a, b).real)
        den = float(torch.sqrt(torch.vdot(a, a).real * torch.vdot(b, b).real))
        corr[i] = num / den if den > 0 else 0.0
        prev = s + 0.5
    return shells / d, corr


def fsc_resolution(freqs, corr, threshold=0.143, apix=1.0):
    """First shell where FSC drops below threshold -> resolution in A."""
    below = np.where(corr < threshold)[0]
    if len(below) == 0:
        return 2 * apix  # Nyquist
    return apix / freqs[below[0]]


def ctf_freqs(d, apix=1.0):
    """Centred (d, d, 2) frequency lattice up to Nyquist (1/(2*apix))."""
    f = np.fft.fftshift(np.fft.fftfreq(d, d=apix))
    fx, fy = np.meshgrid(f, f, indexing="xy")
    return np.stack([fx, fy], axis=-1)
