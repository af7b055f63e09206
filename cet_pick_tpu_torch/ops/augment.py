"""Batched image augmentations for exploration training — port of
``cet_pick_tpu/ops/augment.py`` (the two 2D pipelines and the 3D-subvolume
one).

Rebuild of the reference's torchvision transform pipelines (reference:
cet_pick/datasets/tomo_pre_proj_angle_select_new2d3d.py:49-82 and
cet_pick/utils/image.py:195-324). Every transform is split in two:

* a *draw* of its per-sample parameters from a ``torch.Generator`` on the
  batch's device (``draw_simsiam_params``, ``draw_simsiam_3d_params``);
* a deterministic *apply* of those parameters to a (B, C, H, W) batch
  (``apply_simsiam``, ``apply_simsiam_3d``).

JAX draws from per-sample PRNG keys, so the bits of the draws differ from
JAX's (an intended deviation); the tests feed the applies the parameters
that JAX's keys draw. The C channels of a sample share one draw, so the
2d3d (tilt, slice) pair receives identical spatial randomness, exactly like
torchvision's Compose over a 2-channel tensor.

Pipelines (the reference's strong/weak compositions):
  2d3d mode (tomo_pre_proj_angle_select_new2d3d.py:49-82):
    strong: hflip(.5) -> vflip(.5) -> rotate(±30°) -> center-crop ->
            corner-erase(.5) -> rot90(k~U{0..3}) -> normalize
    weak:   same without the continuous rotation
  3d-only mode (tomo_pre_proj_angle_select_new3d_vol.py:49-89):
    hflip(.5) -> vflip(.5) -> ColorJitter(0.5,0.2,0.3,0.1) ->
    RandomResizedCrop(scale 0.8-1.0 strong / 0.9-1.0 weak, ratio 1) ->
    rot90 -> normalize
  vol mode (augment.py:438-485; tio Compose of datasets/tomo_pre.py, then
  particle_pre.py:48-87), both views alike:
    xy blur(.15) -> gaussian noise(.5) -> xy rotation U(0, 60°)(.75) ->
    centre crop (size // 8 a side) -> znorm(rescale(-3, 3)(znorm)) ->
    flip H or W (1/3 each) -> one of drop / centre-out / swap (.25 each)

The rotation is Paeth's 3-shear form (``_rotate_shear``, augment.py:528-570)
and the resized crop two separable linear interpolations (augment.py:
227-258); each 1D interpolation here gathers its two taps and blends them,
which is the value JAX's interpolation-matrix products give (each row of
those matrices holds two non-zero weights).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _uniform(b, gen, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(b, generator=gen, device=device)


def _randint(lo, hi, gen, device):
    """One integer in [lo, hi) per sample; ``lo`` / ``hi`` are (B,) int
    tensors (hi > lo)."""
    u = torch.rand(lo.shape, generator=gen, device=device, dtype=torch.float64)
    return lo + torch.floor(u * (hi - lo)).long().clamp(max=hi - lo - 1)


# ---------------------------------------------------------------------------
# applies (deterministic, batched over B; per-sample parameters are (B,))
# ---------------------------------------------------------------------------

def _col(v):
    """(B,) -> (B, 1, 1, 1) for broadcasting over (C, H, W)."""
    return v.reshape(-1, 1, 1, 1)


def flips(x, hflip, vflip):
    """Per-sample horizontal (last axis) then vertical flip (augment.py:36-41)."""
    x = torch.where(_col(hflip), x.flip(-1), x)
    return torch.where(_col(vflip), x.flip(-2), x)


def rot90(x, k):
    """Per-sample rotation by k * 90° in the (H, W) plane, as
    ``jnp.rot90(x, k, axes=(1, 2))`` (augment.py:44-48); square images."""
    rots = torch.stack([torch.rot90(x, kk, dims=(2, 3)) for kk in range(4)])
    return rots[k, torch.arange(x.shape[0], device=x.device)]


def _lerp_taps(x, dim, src0, src1, w0, w1):
    """out[..., i, ...] = w0 * x[src0] + w1 * x[src1] along ``dim`` (-1 or
    -2), the indices and weights (B, n_out) or (B, n_other, n_out); a
    negative or out-of-range index reads 0 (zero fill)."""
    n = x.shape[dim]
    pad = [0, 0, 0, 0]
    pad[0 if dim == -1 else 2] = 1
    pad[1 if dim == -1 else 3] = 1
    xp = torch.nn.functional.pad(x, pad)  # index -1 and n read zeros

    def gather(src):
        idx = (src.clamp(-1, n) + 1)
        if dim == -1:  # idx (B, H, W_out): per row
            idx = idx.unsqueeze(1).expand(-1, x.shape[1], -1, -1)
            return torch.gather(xp, -1, idx)
        # idx (B, W, H_out): per column -> (B, C, H_out, W)
        idx = idx.transpose(1, 2).unsqueeze(1).expand(-1, x.shape[1], -1, -1)
        return torch.gather(xp, -2, idx)

    def weight(w):
        return (w.unsqueeze(1) if dim == -1
                else w.transpose(1, 2).unsqueeze(1))

    return weight(w0) * gather(src0) + weight(w1) * gather(src1)


def _shear(x, shift, dim):
    """Linear-interp shift along ``dim`` by ``shift`` (B, n_other) — the
    per-row (dim -1) or per-column (dim -2) amount: out[i] =
    (1 - f) in[i - k] + f in[i - k - 1] for shift = k + f, zero fill
    (``_shear_matrices``, augment.py:512-525)."""
    n = x.shape[dim]
    k = torch.floor(shift)
    f = (shift - k).unsqueeze(-1)
    i = torch.arange(n, device=x.device)
    src0 = i - k.long().unsqueeze(-1)  # (B, n_other, n)
    return _lerp_taps(x, dim, src0, src0 - 1, (1.0 - f).expand_as(src0),
                      f.expand_as(src0))


def _rotate_shear(x, theta):
    """Rotation of every (H, W) plane by ``theta`` (B,) radians about the
    centre by Paeth's 3-shear decomposition R = Sx(-tan θ/2) Sy(sin θ)
    Sx(-tan θ/2), zero fill (``_rotate_vol_xy_shear``, augment.py:528-570).
    Beyond 45° a rot90 is composed first; square images."""
    h, w = x.shape[-2:]
    use90 = theta > math.pi / 4
    x = torch.where(_col(use90), torch.rot90(x, -1, dims=(2, 3)), x)
    th = torch.where(use90, theta - math.pi / 2, theta)
    a = -torch.tan(th / 2.0)
    b = torch.sin(th)
    ys = torch.arange(h, device=x.device, dtype=x.dtype) - (h - 1) / 2.0
    xs = torch.arange(w, device=x.device, dtype=x.dtype) - (w - 1) / 2.0
    sx = a[:, None] * ys  # x-shear: row y shifts by a * y
    x = _shear(x, sx, -1)
    x = _shear(x, b[:, None] * xs, -2)  # y-shear: column x shifts by b * x
    return _shear(x, sx, -1)


def center_crop(x, out_h, out_w):
    h, w = x.shape[-2:]
    top, left = (h - out_h) // 2, (w - out_w) // 2
    return x[..., top:top + out_h, left:left + out_w]


def corner_erase(x, flag, i, j, eh, ew):
    """Set the rectangle [i, i + eh) x [j, j + ew) to 1 where ``flag``
    (augment.py:143-178)."""
    h, w = x.shape[-2:]
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    mask = ((yy >= i[:, None, None]) & (yy < (i + eh)[:, None, None])
            & (xx >= j[:, None, None]) & (xx < (j + ew)[:, None, None])
            & flag[:, None, None])
    return torch.where(mask[:, None], torch.ones_like(x), x)


def color_jitter(x, fb, fc, contrast_last):
    """ColorJitter on single-channel patches (augment.py:181-211):
    brightness clamp(x * fb, 0, 1) and contrast
    clamp((x - mean) * fc + mean, 0, 1), contrast after brightness where
    ``contrast_last``, else before; the mean is over the whole sample."""

    def bright(v):
        return torch.clamp(v * _col(fb), 0.0, 1.0)

    def contr(v):
        m = v.mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp((v - m) * _col(fc) + m, 0.0, 1.0)

    return torch.where(_col(contrast_last), contr(bright(x)),
                       bright(contr(x)))


def _interp_taps(src, n):
    """Two-tap linear interpolation with edge clamping at source positions
    ``src`` (B, m) (``_interp_matrix``, augment.py:214-224)."""
    s = src.clamp(0.0, n - 1.0)
    i0 = torch.floor(s)
    f = s - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), 1.0 - f, f


def resized_crop(x, side, top, left, out_size):
    """Crop the square of ``side`` at (top, left) (B,) and resize it to
    (out_size, out_size), bilinear with PIL-style pixel centres
    (augment.py:227-258)."""
    h, w = x.shape[-2:]
    idx = ((torch.arange(out_size, device=x.device, dtype=x.dtype) + 0.5)
           * (side / out_size)[:, None] - 0.5)
    r0, r1, rw0, rw1 = _interp_taps(top[:, None] + idx, h)
    c0, c1, cw0, cw1 = _interp_taps(left[:, None] + idx, w)
    # rows: the same taps for every column (B, W, out)
    x = _lerp_taps(x, -2, *(t[:, None, :].expand(-1, w, -1)
                            for t in (r0, r1, rw0, rw1)))
    return _lerp_taps(x, -1, *(t[:, None, :].expand(-1, out_size, -1)
                               for t in (c0, c1, cw0, cw1)))


def normalize(x, mean, std):
    """Per-channel (C,) mean/std normalization."""
    return (x - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# the two pipelines: draws and applies
# ---------------------------------------------------------------------------

def draw_simsiam_params(b, h, w, gen, device, strong=True):
    """Per-sample parameters of the 2d3d pipeline for (H, W) patches
    (augment.py:286-310): flips, the rotation angle in radians (strong
    only), the corner-erase rectangle (area 1-2% of the patch, aspect
    0.5-1.5) placed off the central ±6 band (augment.py:143-178) and its
    flag (p 0.5), and the rot90 count."""
    mid_h, mid_w = h // 2, w // 2
    params = {"hflip": _uniform(b, gen, device) < 0.5,
              "vflip": _uniform(b, gen, device) < 0.5}
    if strong:
        params["theta"] = _uniform(b, gen, device, -30.0, 30.0) * math.pi / 180
    area = _uniform(b, gen, device, 0.01, 0.02) * (h * w)
    aspect = torch.exp(_uniform(b, gen, device, math.log(0.5), math.log(1.5)))
    eh = torch.round(torch.sqrt(area * aspect)).clamp(1, max(mid_h - 7, 1))
    ew = torch.round(torch.sqrt(area / aspect)).clamp(1, max(mid_w - 7, 1))

    def side(m, size, extent):
        # top-left corner in [0, m - size - 6) or [m + 6, extent - size)
        size = size.long()
        zero = torch.zeros_like(size)
        a = _randint(zero, torch.clamp(m - size - 6, min=1), gen, device)
        lo2 = torch.full_like(size, m + 6)
        bb = _randint(lo2, torch.clamp(extent - size, min=m + 7), gen, device)
        return torch.where(_uniform(b, gen, device) < 0.5, a, bb)

    params["erase_i"] = side(mid_h, eh, h)
    params["erase_j"] = side(mid_w, ew, w)
    params["erase_h"], params["erase_w"] = eh.long(), ew.long()
    params["erase"] = _uniform(b, gen, device) < 0.5
    params["k"] = torch.randint(0, 4, (b,), generator=gen, device=device)
    return params


def apply_simsiam(x, params, mean, std, out_size):
    """The 2d3d pipeline on (B, C, H, W) with drawn ``params``
    (``simsiam_augment``, augment.py:286-310): flips, rotation (when drawn),
    center crop, corner erase, rot90, normalize."""
    x = flips(x, params["hflip"], params["vflip"])
    if "theta" in params:
        x = _rotate_shear(x, params["theta"])
    x = center_crop(x, out_size, out_size)
    x = corner_erase(x, params["erase"], params["erase_i"], params["erase_j"],
                     params["erase_h"], params["erase_w"])
    return normalize(rot90(x, params["k"]), mean, std)


def draw_simsiam_3d_params(b, h, w, gen, device, strong=True):
    """Per-sample parameters of the 3d-only pipeline (augment.py:313-333):
    flips, the jitter factors (brightness ~U[0.5, 1.5], contrast
    ~U[0.8, 1.2]) and their order, the resized crop's square (side from an
    area fraction ~U[0.8, 1] strong / U[0.9, 1] weak, top and left uniform
    over the room left), and the rot90 count."""
    scale = (0.8, 1.0) if strong else (0.9, 1.0)
    params = {"hflip": _uniform(b, gen, device) < 0.5,
              "vflip": _uniform(b, gen, device) < 0.5,
              "fb": _uniform(b, gen, device, 0.5, 1.5),
              "fc": _uniform(b, gen, device, 0.8, 1.2),
              "contrast_last": _uniform(b, gen, device) < 0.5}
    side = torch.sqrt(_uniform(b, gen, device, *scale) * (h * w))
    side = torch.clamp(side, max=float(min(h, w)))
    params["side"] = side
    params["top"] = _uniform(b, gen, device) * (h - side)
    params["left"] = _uniform(b, gen, device) * (w - side)
    params["k"] = torch.randint(0, 4, (b,), generator=gen, device=device)
    return params


def apply_simsiam_3d(x, params, mean, std, out_size):
    """The 3d-only pipeline on (B, C, H, W) with drawn ``params``
    (``simsiam_augment_3d``, augment.py:313-333): flips, color jitter,
    resized crop, rot90, normalize."""
    x = flips(x, params["hflip"], params["vflip"])
    x = color_jitter(x, params["fb"], params["fc"], params["contrast_last"])
    x = resized_crop(x, params["side"], params["top"], params["left"],
                     out_size)
    return normalize(rot90(x, params["k"]), mean, std)


def simsiam_augment(x, gen, mean, std, out_size, strong=True):
    """The 2d3d pipeline, drawn and applied, on a (B, C, H, W) batch
    (augment.py:286-310); one draw per sample, shared by its C channels."""
    b, _, h, w = x.shape
    params = draw_simsiam_params(b, h, w, gen, x.device, strong)
    return apply_simsiam(x, params, mean, std, out_size)


def simsiam_augment_3d(x, gen, mean, std, out_size, strong=True):
    """The 3d-only pipeline, drawn and applied, on a (B, C, H, W) batch
    (augment.py:313-333)."""
    b, _, h, w = x.shape
    params = draw_simsiam_3d_params(b, h, w, gen, x.device, strong)
    return apply_simsiam_3d(x, params, mean, std, out_size)


# ---------------------------------------------------------------------------
# the 3D-subvolume (vol) pipeline
# ---------------------------------------------------------------------------

def vol_out_size(vol_size):
    """Post-crop subvolume shape: size - 2 * (size // 8) per axis (the tio
    Crop(size // 8) at tomo_pre.py:57; augment.py:488-491)."""
    return tuple(int(s) - 2 * (int(s) // 8) for s in vol_size)


def vol_test_view(vols):
    """Deterministic test-time view of (N, D, H, W) numpy subvolumes for
    embedding: the centre crop and znorm / rescale / znorm with numpy's
    float32 reductions, copied from augment.py:494-512 so that the embed
    input is byte-identical to JAX's."""
    d, h, w = vols.shape[1:]
    od, oh, ow = vol_out_size((d, h, w))
    x = vols[:, (d - od) // 2: (d - od) // 2 + od,
             (h - oh) // 2: (h - oh) // 2 + oh,
             (w - ow) // 2: (w - ow) // 2 + ow].astype(np.float32)
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        v = x[i]
        v = (v - v.mean()) / max(v.std(), 1e-6)
        mn, mx = v.min(), v.max()
        v = -3.0 + (v - mn) / max(mx - mn, 1e-12) * 6.0
        out[i] = (v - v.mean()) / max(v.std(), 1e-6)
    return out


def _col3(v):
    """(B,) -> (B, 1, 1, 1) over (D, H, W)."""
    return v.reshape(-1, 1, 1, 1)


def _znorm(x):
    """Per-sample (x - mean) / max(std, 1e-6) over (D, H, W) (augment.py:
    347-348; the population std)."""
    var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
    return (x - mean) / torch.clamp(torch.sqrt(var), min=1e-6)


def _rescale(x, lo=-3.0, hi=3.0):
    """Per-sample min-max rescale to [lo, hi] (augment.py:351-353)."""
    mn = x.amin(dim=(1, 2, 3), keepdim=True)
    mx = x.amax(dim=(1, 2, 3), keepdim=True)
    return lo + (x - mn) / torch.clamp(mx - mn, min=1e-12) * (hi - lo)


def _blur_xy(x, t):
    """3x3 binomial xy blur with edge padding, blended by the per-sample
    strength ``t`` (B,) (augment.py:356-363)."""
    p = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    bl = p[:, :, :-2] * 0.25 + p[:, :, 1:-1] * 0.5 + p[:, :, 2:] * 0.25
    p = torch.cat([bl[..., :1], bl, bl[..., -1:]], dim=3)
    bl = p[..., :-2] * 0.25 + p[..., 1:-1] * 0.5 + p[..., 2:] * 0.25
    t = _col3(t)
    return x * (1.0 - t) + bl * t


def _rotate_bilinear(x, theta):
    """Rotation of every (H, W) plane of (B, C, H, W) by ``theta`` (B,)
    about its centre, one bilinear resample with zero fill
    (``_rotate_vol_xy`` and ``_bilinear_sample``, augment.py:100-125,
    366-378); the rotation of non-square slices."""
    b, c, h, w = x.shape
    dev = x.device
    yr = (torch.arange(h, device=dev, dtype=x.dtype) - (h - 1) / 2.0)[:, None]
    xr = (torch.arange(w, device=dev, dtype=x.dtype) - (w - 1) / 2.0)[None, :]
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    ys = cos * yr - sin * xr + (h - 1) / 2.0  # (B, H, W)
    xs = sin * yr + cos * xr + (w - 1) / 2.0
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    y0 = y0.long()
    x0 = x0.long()
    flat = x.reshape(b, c, h * w)

    def tap(yi, xi):
        ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(x.dtype)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
        v = torch.gather(flat, 2, idx.expand(-1, c, -1)).reshape(b, c, h, w)
        return v, ok[:, None]

    p00, v00 = tap(y0, x0)
    p01, v01 = tap(y0, x0 + 1)
    p10, v10 = tap(y0 + 1, x0)
    p11, v11 = tap(y0 + 1, x0 + 1)
    return (p00 * ((1 - wy) * (1 - wx) * v00) + p01 * ((1 - wy) * wx * v01)
            + p10 * (wy * (1 - wx) * v10) + p11 * (wy * wx * v11))


def _axis_masks(starts, diams, shape, device):
    """Per-axis (B, n) membership of the blocks at ``starts`` (B, 3)."""
    masks = []
    for ax, (dd, n) in enumerate(zip(diams, shape)):
        i = torch.arange(n, device=device)[None]
        s = starts[:, ax:ax + 1]
        masks.append((i >= s) & (i < s + dd))
    return masks


def _box(masks):
    md, mh, mw = masks
    return md[:, :, None, None] & mh[:, None, :, None] & mw[:, None, None, :]


def _drop_out(x, starts, diams):
    """Zero the block of ``diams`` at ``starts`` (B, 3) (augment.py:
    409-414)."""
    mask = _box(_axis_masks(starts, diams, x.shape[1:], x.device))
    return torch.where(mask, torch.zeros_like(x), x)


def _center_out(x, diams):
    """Keep only the central xy band, all z (augment.py:417-427)."""
    _, d, h, w = x.shape
    ih = torch.arange(h, device=x.device)
    iw = torch.arange(w, device=x.device)
    keep = (((ih >= h // 2 - diams[1]) & (ih < h // 2 + diams[1]))[:, None]
            & ((iw >= w // 2 - diams[2]) & (iw < w // 2 + diams[2]))[None])
    return torch.where(keep, x, torch.zeros_like(x))


def _take(x, idx, dim):
    """x gathered along ``dim`` (1..3) at per-sample indices (B, n)."""
    shape = [idx.shape[0], 1, 1, 1]
    shape[dim] = idx.shape[1]
    return torch.gather(x, dim, idx.reshape(shape).expand(
        *[x.shape[a] if a != dim else idx.shape[1] for a in range(4)]))


def _swap_out(x, s0, s1, diams):
    """Swap the blocks of ``diams`` at ``s0`` and ``s1`` (B, 3): block b
    (at s1) is written at s0, then block a (at s0) at s1, so where the two
    overlap the second write wins, as JAX's two ``dynamic_update_slice``
    calls do (augment.py:430-439)."""
    shape = x.shape[1:]
    in0 = _axis_masks(s0, diams, shape, x.device)
    in1 = _axis_masks(s1, diams, shape, x.device)
    src0, src1 = x, x
    for ax in range(3):
        i = torch.arange(shape[ax], device=x.device)[None]
        src1 = _take(src1, torch.where(in1[ax], i - s1[:, ax:ax + 1]
                                       + s0[:, ax:ax + 1], i), ax + 1)
        src0 = _take(src0, torch.where(in0[ax], i - s0[:, ax:ax + 1]
                                       + s1[:, ax:ax + 1], i), ax + 1)
    return torch.where(_box(in1), src1, torch.where(_box(in0), src0, x))


def _offcenter_start(b, dim, diam, gen, device):
    """Block starts (B,) avoiding the central band: U over [0, mid -
    2 diam) + [mid + diam, dim - diam), clipped (augment.py:381-394)."""
    mid = dim // 2
    n1 = max(mid - 2 * diam, 0)
    lo2 = mid + diam
    n2 = max(dim - diam - lo2, 0)
    u = torch.randint(0, max(n1 + n2, 1), (b,), generator=gen, device=device)
    start = torch.where(u < n1, u, lo2 + (u - n1))
    return start.clamp(0, max(dim - diam, 0))


def vol_diams(vol_size):
    """(drop / swap block, centre band) diameters from the pre-crop size
    (particle_pre.py:53-54; augment.py:458-459)."""
    return (tuple(max(s // 8, 1) for s in vol_size),
            tuple(max(s // 4, 1) for s in vol_size))


def draw_simsiam_vol_params(b, vol_size, gen, device):
    """Per-sample parameters of the vol pipeline for (D, H, W) = ``vol_size``
    subvolumes (augment.py:462-483): the blur flag (p .15) and strength, the
    noise tensor, its scale U(0, .25) and flag (p .5), the rotation angle
    U(0, 60°) in radians and its flag (p .75), the flip draw ``fp`` and the
    corruption draw ``bp`` (uniforms), and the drop block's and the two swap
    blocks' starts (B, 3) on the post-crop grid."""
    shape = vol_out_size(vol_size)
    drop, _ = vol_diams(vol_size)

    def starts():
        return torch.stack([_offcenter_start(b, n, dd, gen, device)
                            for n, dd in zip(shape, drop)], dim=1)

    return {"blur_t": _uniform(b, gen, device),
            "blur": _uniform(b, gen, device) < 0.15,
            "noise": torch.randn((b,) + tuple(vol_size), generator=gen,
                                 device=device),
            "noise_scale": _uniform(b, gen, device, 0.0, 0.25),
            "add_noise": _uniform(b, gen, device) < 0.5,
            "theta": _uniform(b, gen, device, 0.0, 60.0) * math.pi / 180.0,
            "rotate": _uniform(b, gen, device) < 0.75,
            "fp": _uniform(b, gen, device),
            "bp": _uniform(b, gen, device),
            "drop_start": starts(), "swap_s0": starts(), "swap_s1": starts()}


def apply_simsiam_vol(x, params):
    """The vol pipeline on (B, D, H, W) with drawn ``params``
    (``simsiam_augment_vol``, augment.py:442-485) -> (B, *vol_out_size)."""
    b, d, h, w = x.shape
    od, oh, ow = vol_out_size((d, h, w))
    drop, center = vol_diams((d, h, w))
    x = torch.where(_col3(params["blur"]), _blur_xy(x, params["blur_t"]), x)
    x = torch.where(_col3(params["add_noise"]),
                    x + params["noise"] * _col3(params["noise_scale"]), x)
    # square slices: the 3-shear rotation over D as channels
    # (_rotate_vol_xy_shear, augment.py:528-570); else one bilinear resample
    rotate = _rotate_shear if h == w else _rotate_bilinear
    x = torch.where(_col3(params["rotate"]), rotate(x, params["theta"]), x)
    x = x[:, (d - od) // 2:(d - od) // 2 + od, (h - oh) // 2:(h - oh) // 2 + oh,
          (w - ow) // 2:(w - ow) // 2 + ow]
    x = _znorm(_rescale(_znorm(x)))
    fp = _col3(params["fp"])
    x = torch.where(fp < 0.33, x.flip(2), torch.where(fp > 0.66, x.flip(3), x))
    bp = _col3(params["bp"])
    return torch.where(
        bp < 0.25, _drop_out(x, params["drop_start"], drop),
        torch.where(bp < 0.5, _center_out(x, center),
                    torch.where(bp < 0.75, _swap_out(
                        x, params["swap_s0"], params["swap_s1"], drop), x)))


def simsiam_augment_vol(x, gen, mean=None, std=None, out_size=None,
                        strong=True):
    """The vol pipeline, drawn and applied, on a (B, D, H, W) batch
    (augment.py:442-485). ``mean`` / ``std`` / ``strong`` are accepted for
    the patch pipelines' signature and unused, as in JAX: both views are
    drawn alike and z-normalized per sample; ``out_size`` is always
    ``vol_out_size`` of the input."""
    params = draw_simsiam_vol_params(x.shape[0], x.shape[1:], gen, x.device)
    return apply_simsiam_vol(x, params)
