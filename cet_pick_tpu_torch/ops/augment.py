"""Batched image augmentations for exploration training — port of
``cet_pick_tpu/ops/augment.py`` (the two 2D pipelines).

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

The rotation is Paeth's 3-shear form (``_rotate_shear``, augment.py:528-570)
and the resized crop two separable linear interpolations (augment.py:
227-258); each 1D interpolation here gathers its two taps and blends them,
which is the value JAX's interpolation-matrix products give (each row of
those matrices holds two non-zero weights).
"""

from __future__ import annotations

import math

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
