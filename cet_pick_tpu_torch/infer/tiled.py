"""Whole-volume heatmap inference, tiled along z (and xy) with halo overlap
— port of ``cet_pick_tpu/infer/tiled.py``.

The reference pushes entire volumes through the net in one forward
(reference: cet_pick/test.py:77-85, detectors/tomo_det.py:23-40). Here
volumes stream through in z windows:

* the 2D UNet trunk is slice-wise (no z mixing), and the 3D head's z
  receptive field is exactly +-3, so a halo of 3 slices makes the tiled
  output equal to the full-volume forward in every tile's core;
* NMS/top-K decode runs once on the stitched heatmap, so tile borders
  cannot split or duplicate peaks.

Windows near the z borders are shifted INWARD (start clamped to
[0, d - win]), never zero-padded, so every core slice has >= halo slices of
real context or sits at the true border, where the convolutions' own zero
padding applies — exactly as in a full-volume forward.

Ranks: under a process group of several ranks (``test`` / ``watch`` with
``--mesh_shape``, ``parallel/``) the same plan is split over the ranks: the xy tiles in contiguous blocks when there are several, else the
z windows. Each rank runs its own through the same model (one fused
forward of its windows), and every core is then broadcast from its rank,
so each rank stitches the single-process heatmap. JAX instead shards H
over the mesh with XLA's halo exchanges (tiled.py:120-145); the plan's
halos already make every core exact, so no exchange is needed.

Memory envelope: when the fused window batch would exceed the activation
budget, xy tiles itself with the full-network halo. The budget comes from
the device's free memory (``torch.cuda.mem_get_info`` plus the caching
allocator's unused blocks) unless the caller passes ``xy_budget``; on the
CPU there is no envelope unless one is given.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.parallel import dist as D

Z_HALO = 3  # z receptive-field radius of the 3D head (unet_small.py:39-61)

# xy tiling: the whole network mixes xy, so the halo must cover the full
# architectural xy receptive field, and window starts must stay on the
# total-downsample grid (stem 2 x 2^(n_blocks-1) max pools), or the
# ceil-mode pools pair different pixels than the full-volume forward.


def xy_align(n_blocks: int, stem_stride: int = 2) -> int:
    """Total xy downsample stride: stem x pool(2)^(n_blocks-1)."""
    return stem_stride * 2 ** (n_blocks - 1)


def xy_halo(n_blocks: int, stem_stride: int = 2) -> int:
    """Architectural xy receptive-field radius in INPUT pixels, rounded up
    to the pooling grid (derivation at cet_pick_tpu/infer/tiled.py:50-61):
    2^(n+2) + 2 at the UNet grid, scaled by the stem stride, plus the
    stem's own reach."""
    raw = stem_stride * (2 ** (n_blocks + 2) + 2)
    raw += 6 if stem_stride == 2 else stem_stride
    a = xy_align(n_blocks, stem_stride)
    return -(-raw // a) * a


def _free_device_bytes(device) -> int:
    """Device memory this process can allocate: the free bytes of
    ``torch.cuda.mem_get_info`` plus the blocks PyTorch's caching allocator
    holds but no tensor uses (after a large forward in the same process,
    ``mem_get_info`` alone counts them as taken)."""
    free = torch.cuda.mem_get_info(device)[0]
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def check_untiled_fits(model, shape, device, xy_budget=None, views=1):
    """Raise ``MemoryError`` where one untiled forward of a (D, H, W)
    volume would not fit the envelope: ``views`` x D x H x W x the model's
    bytes per voxel against ``MEMORY_FRACTION`` of the device's free
    memory, or ``xy_budget`` bytes (the CPU has no limit)."""
    if xy_budget is None:
        xy_budget = (TiledHeatmapInference.MEMORY_FRACTION
                     * _free_device_bytes(device)
                     if torch.device(device).type == "cuda" else math.inf)
    d, h, w = (int(s) for s in shape[-3:])
    need = views * d * h * w * bytes_per_voxel(model)
    if need > xy_budget:
        raise MemoryError(
            f"a {d}x{h}x{w} volume needs about {need / 2**30:.1f} GiB for "
            f"this model's untiled forward, over its budget of "
            f"{xy_budget / 2**30:.1f} GiB; the forward is not tiled: crop "
            f"the volume")


def bytes_per_voxel(model) -> float:
    """Peak device bytes per input voxel of ``model``'s forward in its
    compute dtype (``model.dtype``, float32 where it has none): its own
    ``bytes_per_voxel`` / ``bytes_per_voxel_bf16``, else the unet_N values
    below. The JAX package keeps one constant whatever the dtype
    (cet_pick_tpu/infer/tiled.py:80); here each dtype has its measured
    one (ROADMAP Queue 3)."""
    if getattr(model, "dtype", torch.float32) == torch.bfloat16:
        return float(getattr(model, "bytes_per_voxel_bf16",
                             TiledHeatmapInference.BYTES_PER_VOXEL_BF16))
    return float(getattr(model, "bytes_per_voxel",
                         TiledHeatmapInference.BYTES_PER_VOXEL))


class TiledHeatmapInference:
    """z-tiled (and optionally xy-tiled) `hm` forward for one model."""

    # Peak device bytes per input voxel of the fused window batch (f32,
    # unet_4): chip_smoke.py measured 296.5 (peak allocated over the 4x70
    # slices of 512x512 it fuses, H100 80GB HBM3) — the trunk's non-inplace
    # BatchNorm outputs, the up blocks' concats and cuDNN workspace; a
    # count of live tensors alone gives ~160. Rounded up for headroom. A
    # model with a ``bytes_per_voxel`` attribute (unetw_N) sets its own.
    BYTES_PER_VOXEL = 320.0
    # The same under bfloat16: chip_smoke.py measured 164.0-166.0 for
    # unet_4 (its ``bf16_models`` and ``bf16_test`` phases, H100 80GB HBM3,
    # 700 W): the bf16 activations, and the float32 copies BatchNorm's f32
    # arithmetic makes of one tensor at a time. Rounded up as the f32 one.
    BYTES_PER_VOXEL_BF16 = 180.0
    # share of the device's free memory the fused window batch may take
    MEMORY_FRACTION = 0.5

    def __init__(self, model, tile_z: int = 64, halo: int = Z_HALO,
                 tile_xy=None, tta: bool = False, xy_budget=None):
        self.model = model.eval()
        # split the plan over the process group's ranks (module docstring);
        # every rank must then run the same calls
        self.split = D.world() > 1
        self.device = next(model.parameters()).device
        # a model with ``untiled`` set (the 3D detectors: GroupNorm spans
        # the volume) runs one forward over the whole volume; the memory
        # envelope refuses a volume that cannot fit instead of tiling it
        self.untiled = getattr(model, "untiled", False)
        if self.untiled:
            tile_z, tile_xy = 10 ** 9, None
        self.tile_z = int(tile_z)
        self.halo = int(halo)
        # flip test-time augmentation: average the heatmap over the 4
        # xy-flip views of every window (4x the forward compute)
        self.tta = bool(tta)
        # (tile_h, tile_w) in input pixels, 0/None = never tile that axis
        self.tile_xy = tuple(int(t) for t in tile_xy) if tile_xy else None
        if xy_budget is None:
            xy_budget = (self.MEMORY_FRACTION * _free_device_bytes(self.device)
                         if self.device.type == "cuda" else math.inf)
        self.xy_budget = float(xy_budget)
        self.xy_down = model.stem_stride
        self.bytes_per_voxel = bytes_per_voxel(model)
        if not self.untiled:
            self.xy_halo = xy_halo(model.n_blocks, self.xy_down)
            self.xy_align = xy_align(model.n_blocks, self.xy_down)

    def _dequant(self, t, lo, hi):
        """Affine dequantization in f32 on the device; float inputs pass
        through unchanged via (lo, hi) = (0, 1)."""
        lo = torch.tensor(lo, dtype=torch.float32, device=self.device)
        hi = torch.tensor(hi, dtype=torch.float32, device=self.device)
        return (t.float() - lo) / torch.clamp(hi - lo, min=1e-12)

    def _tile_forward(self, tile, lo, hi):
        """(tz, H, W) uint8 or float window -> (tz, H', W') probabilities."""
        return self._hm_probs(self._dequant(tile, lo, hi)[None])[0]

    def _hm_probs(self, x):
        """(B, D, H, W) float input -> (B, D, H', W') heatmap probabilities.

        With ``tta`` the 4 xy-flip views ride the conv batch together and
        the un-flipped probabilities are averaged. Un-flipping is a pure
        reversal of the output axis for even extents."""
        if self.tta:
            x = torch.cat([x, x.flip(-1), x.flip(-2), x.flip(-2, -1)], dim=0)
        out = self.model(x, active_heads=("hm",))
        hm = sigmoid_clamped(out["hm"][..., 0])
        if self.tta:
            h0, hlr, hud, hb = hm.chunk(4, dim=0)
            hm = (h0 + hlr.flip(-1) + hud.flip(-2) + hb.flip(-2, -1)) * 0.25
        return hm

    def _check_tta_shape(self, h, w):
        """Flip-TTA's output un-flip mapping needs even xy extents (odd
        extents put the two grids half a cell apart)."""
        dn = self.xy_down
        if self.tta and (h % dn or w % dn):
            raise ValueError(
                f"--tta needs H and W divisible by the output stride {dn} "
                f"(got {h}x{w}); pad/crop the volume or drop --tta"
            )

    def _put_volume(self, volume):
        """Host array or tensor -> tensor on the model's device."""
        if isinstance(volume, np.ndarray):
            volume = torch.from_numpy(volume)
        return volume.to(self.device)

    def _window_plan(self, d):
        """(start, core_lo, core_hi) per tile for depth d."""
        tz, halo = self.tile_z, self.halo
        win = tz + 2 * halo
        plan = []
        n_tiles = -(-d // tz)
        for t in range(n_tiles):
            z0 = t * tz
            z1 = min(z0 + tz, d)
            s = min(max(z0 - halo, 0), d - win)
            plan.append((s, z0 - s, z1 - s))
        return tuple(plan), win

    def _xy_plan(self, dim, tile):
        """Shifted-inward xy window plan, or None when one window covers the
        axis. Starts/cores stay on the pooling grid (see xy_halo/xy_align)."""
        if not tile:
            return None
        halo, align = self.xy_halo, self.xy_align
        tile = max(tile - tile % align, align)
        win = tile + 2 * halo
        if dim <= win:
            return None
        if dim % align:
            # misaligned extents cannot tile exactly; run this axis untiled
            warnings.warn(
                f"xy extent {dim} is not a multiple of {align}; running "
                f"this axis untiled (pad/crop the volume to enable xy "
                f"tiling)", stacklevel=3,
            )
            return None
        plan = []
        for t in range(-(-dim // tile)):
            a0 = t * tile
            a1 = min(a0 + tile, dim)
            s = min(max(a0 - halo, 0), dim - win)
            plan.append((s, a0, a1))
        return tuple(plan), win

    def _auto_xy(self, n_windows, win_d, h, w):
        """A square (tile_h, tile_w) when the fused window batch would
        exceed the activation budget; None when it fits untiled."""
        views = 4 if self.tta else 1  # flip-TTA rides the conv batch
        est = views * n_windows * win_d * h * w * self.bytes_per_voxel
        if est <= self.xy_budget:
            return None
        a, halo = self.xy_align, self.xy_halo
        max_win_area = self.xy_budget / (
            views * n_windows * win_d * self.bytes_per_voxel
        )
        side = int(math.floor(math.sqrt(max_win_area))) - 2 * halo
        tile = max(a, side - side % a)
        return (tile, tile)

    def _window_batch_est(self, n_windows, win_d, h, w, tile_xy):
        """Activation estimate of the fused window batch AFTER xy tiling at
        ``tile_xy``."""
        views = 4 if self.tta else 1
        a, halo = self.xy_align, self.xy_halo

        def extent(t, dim):
            if not t:
                return dim
            t = max(t - t % a, a)
            return min(dim, t + 2 * halo)

        wh, ww = extent(tile_xy[0], h), extent(tile_xy[1], w)
        return views * n_windows * win_d * wh * ww * self.bytes_per_voxel

    def _effective_xy(self, n_windows, win_d, h, w):
        """Merge the explicit ``--tile H W`` with the memory envelope: the
        smaller tile wins per axis; an explicit 0 opts that axis out. An
        untiled detector raises where the envelope would tile."""
        if self.untiled:
            # the 3D detectors are not tiled: GroupNorm spans the volume
            check_untiled_fits(self.model, (n_windows * win_d, h, w),
                               self.device, self.xy_budget,
                               views=4 if self.tta else 1)
            return None
        auto = self._auto_xy(n_windows, win_d, h, w)
        if auto is None:
            return self.tile_xy
        if self.tile_xy is None:
            return auto
        return tuple(t if t == 0 else min(t, a)
                     for t, a in zip(self.tile_xy, auto))

    def _xy_tiled(self, volume, z_forward, tile_xy=None):
        """Decompose xy, run ``z_forward`` per xy window, stitch output cores
        (output grid = input / stem stride). Returns None when no xy
        tiling is needed."""
        d, h, w = volume.shape
        tile_xy = tile_xy if tile_xy is not None else self.tile_xy
        th, tw = tile_xy if tile_xy else (0, 0)
        hplan = self._xy_plan(h, th)
        wplan = self._xy_plan(w, tw)
        if hplan is None and wplan is None:
            return None
        # passthrough axes keep the window's full output extent; tiled axes
        # are on the stride grid by construction, so the core is
        # [(a0-s)/dn, (a1-s)/dn)
        hp, hwin = hplan if hplan else ((None,), h)
        wp, wwin = wplan if wplan else ((None,), w)

        def core(entry):
            if entry is None:
                return 0, slice(None)
            s, a0, a1 = entry
            dn = self.xy_down
            return s, slice((a0 - s) // dn, (a1 - s) // dn)

        volume = self._put_volume(volume)
        tiles = [(he, we) for he in hp for we in wp]

        def tile_core(he, we):
            (sy, ysl), (sx, xsl) = core(he), core(we)
            return z_forward(volume[:, sy:sy + hwin, sx:sx + wwin])[:, ysl,
                                                                    xsl]

        split, self.split = self.split, False  # z stays whole in a tile
        try:
            cores = self._split_map(tile_core, tiles, split)
        finally:
            self.split = split
        rows = [torch.cat(cores[i:i + len(wp)], dim=2)
                for i in range(0, len(cores), len(wp))]
        return torch.cat(rows, dim=1)

    def _split_map(self, fn, items, split):
        """``[fn(*item) for item in items]``; with ``split`` each rank
        computes its block of the items, then each result is broadcast
        from its rank."""
        if not split:
            return [fn(*it) for it in items]
        n = len(items)
        return self._gather({i: fn(*it) for i, it in enumerate(items)
                             if D.owner(i, n) == D.rank()}, n)

    def _gather(self, mine, n):
        """The ``n`` cores in order on every rank: ``mine`` ({index: core})
        computed here, each other broadcast from its rank
        (``parallel/dist.share``)."""
        return [D.share(mine.get(i), D.owner(i, n), 3, device=self.device)
                for i in range(n)]

    @torch.inference_mode()
    def fused(self, volume, lo: float = 0.0, hi: float = 1.0):
        """Whole-volume heatmap with all z windows in one batched forward
        (z folds into one large conv batch), cores re-stitched. Equal to
        the streamed path; trades peak activation memory for fewer, larger
        launches."""
        d, h, w = volume.shape
        self._check_tta_shape(h, w)
        tz, halo = self.tile_z, self.halo
        if d <= tz + 2 * halo:
            n_win, win_d = 1, d
        else:
            plan, win_d = self._window_plan(d)
            n_win = len(plan)
        txy = self._effective_xy(n_win, win_d, h, w)
        if txy is not None and n_win > 1 and self._window_batch_est(
                n_win, win_d, h, w, txy) > self.xy_budget:
            # even at the clamped tile the fused batch (ALL z windows live)
            # cannot fit: stream the z windows instead, one live at a time
            return self(volume, lo=lo, hi=hi)
        tiled = self._xy_tiled(
            volume, lambda win_: self.fused(win_, lo=lo, hi=hi), tile_xy=txy)
        if tiled is not None:
            return tiled
        if d <= tz + 2 * halo:
            return self._forward_z(volume, lo=lo, hi=hi)
        plan, win = self._window_plan(d)
        volume = self._put_volume(volume)
        n = len(plan)
        ids = [i for i in range(n)
               if not self.split or D.owner(i, n) == D.rank()]
        cores = {}
        if ids:
            windows = torch.stack([volume[plan[i][0]:plan[i][0] + win]
                                   for i in ids])
            hm = self._hm_probs(self._dequant(windows, lo, hi))  # (T, win, ..)
            cores = {i: hm[j, plan[i][1]:plan[i][2]]
                     for j, i in enumerate(ids)}
        return torch.cat(self._gather(cores, n) if self.split
                         else [cores[i] for i in range(n)], dim=0)

    @torch.inference_mode()
    def __call__(self, volume, lo: float = 0.0, hi: float = 1.0):
        """volume: (D, H, W) float32 — or uint8 with (lo, hi) dequantization
        bounds from ``io.loader.preprocess_quantized`` — as a host array or
        a tensor -> stitched (D, H//s, W//s) heatmap probabilities on the
        model's device, streamed one z window at a time. When ``tile_xy``
        is set and the volume exceeds it, the same scheme tiles H/W with the
        full-network xy halo."""
        d, h, w = volume.shape
        self._check_tta_shape(h, w)
        win_d = min(d, self.tile_z + 2 * self.halo)
        txy = self._effective_xy(1, win_d, h, w)  # streamed: 1 window live
        tiled = self._xy_tiled(
            volume, lambda win_: self._forward_z(win_, lo=lo, hi=hi),
            tile_xy=txy)
        if tiled is not None:
            return tiled
        return self._forward_z(volume, lo=lo, hi=hi)

    def _forward_z(self, volume, lo: float = 0.0, hi: float = 1.0):
        d, h, w = volume.shape
        volume = self._put_volume(volume)
        plan, win = self._window_plan(d)
        if d <= win:
            # a single window covers the volume; exact by construction
            plan = ((0, 0, d),)
        cores = self._split_map(
            lambda s, c0, c1: self._tile_forward(volume[s:s + win], lo,
                                                 hi)[c0:c1],
            plan, self.split)
        return torch.cat(cores, dim=0)
