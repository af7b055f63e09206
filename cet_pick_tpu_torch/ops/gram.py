"""Fused row statistics of the contrastive similarity matrix, with their
gradients — the gram work of the refinement and supervised train steps.

Ports of the TPU kernels ``cet_pick_tpu/ops/pallas_gram.py``:

* ``gram_row_stats`` (:153, custom VJP) — the debiased contrastive loss of
  the default step. With l_ij = (f_i . f_j - 1) / T off the diagonal and
  l_ii = 0, e_ij = exp(l_ij): returns (sum_j e_ij p_j, sum_j e_ij o_j,
  sum_j e_ij) per row.
* ``gram_logit_stats`` (:290, custom VJP) — the supervised contrastive
  loss of the ``--pn`` step: returns (sum_j l_ij p_j, sum_j e_ij) per row.
* ``gram_supcon_v2_stats`` (:422, custom VJP) — the single-view supcon of
  ``train --task cr``, on raw features. With s_ij = f_i . f_j / T off the
  diagonal and s_ii = 0 (before the max): returns (max_j s_ij, detached;
  sum_j s_ij p_j; sum_j s_ij n_j; sum_j exp(s_ij - max)) per row.

Same signatures as JAX's, plus an optional leading batch axis: ``feats``
(M, C) or (B, M, C) float32 (L2-normalized for the first two); masks (M,)
or (B, M). Gradients flow to ``feats`` only.

* A CUDA tensor goes through ``GramRowStats`` / ``GramLogitStats`` /
  ``GramSupconV2Stats``, whose forward and backward launch the hand-written
  Hopper kernels of ``csrc/gram_stats.cu`` (built by nvcc at first use,
  ``ops/_build.py``). Each launch adds one to the function's ``launches``
  count: ``fwd``; ``bwd``, the fused backward (dF = (W + W^T).F in one
  pass); and ``bwd_reduce``, the fixed-order sum of the backward's
  partials when its column tiles are cut into slices (``_slices``).
* A CPU tensor takes the plain version, ``gram_row_stats_plain`` /
  ``gram_logit_stats_plain`` / ``gram_supcon_v2_stats_plain``: dense torch
  in row blocks (matmul, exp, masked sums), each block under
  ``torch.utils.checkpoint`` so that autograd keeps no (block, M) stripe —
  the reason of ``train/losses.py:241-246`` in JAX. The tests and
  ``chip_smoke.py`` hold the kernels against it on the card.
* Anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.checkpoint import checkpoint

from cet_pick_tpu_torch.ops._build import load_library

_ROW, _LOGIT, _V2 = 0, 1, 2
_MAX_C = 128  # widest C the kernels are instantiated for
_TILE = 64  # rows of a kernel block's tile
_TARGET_BLOCKS = 1024  # the backward's grid: a few waves of 132 SMs


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _blocked(block_fn, feats, masks, temp, block):
    """Run ``block_fn(rows, idx, feats, *masks, temp)`` over row blocks of
    (B, M, C) features and concatenate its per-row outputs along M. Under
    autograd every block is recomputed in the backward."""
    m = feats.shape[1]
    outs = []
    for start in range(0, m, block):
        idx = torch.arange(start, min(start + block, m), device=feats.device)
        rows = feats[:, start:start + block]
        if torch.is_grad_enabled() and feats.requires_grad:
            outs.append(checkpoint(block_fn, rows, idx, feats, *masks, temp,
                                   use_reentrant=False))
        else:
            outs.append(block_fn(rows, idx, feats, *masks, temp))
    return tuple(torch.cat(o, dim=1) for o in zip(*outs))


def _masked_logits(rows, idx, feats, temp):
    """(B, rb, M) logits (f_i . f_j / T - 1/T) with the diagonal zeroed — the
    order of operations of JAX's ``_row_stats_blocked``: the sims divided by
    T, then shifted by the constant 1/T (the row max of unit features)."""
    sims = torch.matmul(rows, feats.transpose(-1, -2)) / temp
    col = torch.arange(feats.shape[1], device=feats.device)
    offdiag = (col[None, :] != idx[:, None]).to(sims.dtype)
    return (sims - 1.0 / temp) * offdiag


def _row_block(rows, idx, feats, pos, other, temp):
    e = torch.exp(_masked_logits(rows, idx, feats, temp))  # diagonal: 1
    return ((e * pos[:, None, :]).sum(-1), (e * other[:, None, :]).sum(-1),
            e.sum(-1))


def _logit_block(rows, idx, feats, pos, temp):
    logits = _masked_logits(rows, idx, feats, temp)        # diagonal: 0
    return (logits * pos[:, None, :]).sum(-1), torch.exp(logits).sum(-1)


def _v2_block(rows, idx, feats, pos, neg, temp):
    """Raw sims with the diagonal set to 0 before the row max
    (pallas_gram.py:370-383); the max is detached."""
    sims = torch.matmul(rows, feats.transpose(-1, -2)) / temp
    col = torch.arange(feats.shape[1], device=feats.device)
    sims = torch.where(col[None, :] != idx[:, None], sims, 0.0)
    mx = sims.detach().amax(-1)
    return (mx, (sims * pos[:, None, :]).sum(-1),
            (sims * neg[:, None, :]).sum(-1),
            torch.exp(sims - mx[..., None]).sum(-1))


def gram_row_stats_plain(feats, pos_mask, other_mask, temp, block=1024):
    """Plain torch ``gram_row_stats`` on (B, M, C) features and (B, M)
    masks; differentiable by autograd."""
    return _blocked(_row_block, feats, (pos_mask, other_mask), temp, block)


def gram_logit_stats_plain(feats, pos_mask, temp, block=1024):
    """Plain torch ``gram_logit_stats`` on (B, M, C) and (B, M)."""
    return _blocked(_logit_block, feats, (pos_mask,), temp, block)


def gram_supcon_v2_stats_plain(feats, pos_mask, neg_mask, temp, block=1024):
    """Plain torch ``gram_supcon_v2_stats`` on (B, M, C) raw features and
    (B, M) masks; the row max carries no gradient."""
    return _blocked(_v2_block, feats, (pos_mask, neg_mask), temp, block)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _cuda_fns():
    lib = load_library("gram_stats")
    fwd = lib.gram_stats_fwd_f32
    fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.gram_stats_bwd_f32
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    red = lib.gram_stats_bwd_reduce_f32
    red.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    red.restype = ctypes.c_int
    return fwd, bwd, red


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(name, counts, key, fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} {key} kernel launch failed: CUDA error "
                           f"{err}")
    counts[key] += 1


def _public(variant):
    """(public wrapper, its number of outputs) of a kernel variant."""
    return {_ROW: (gram_row_stats, 3), _LOGIT: (gram_logit_stats, 2),
            _V2: (gram_supcon_v2_stats, 4)}[variant]


def _fwd(variant, feats, masks, temp):
    b, m, _ = feats.shape
    public, n_out = _public(variant)
    outs = [torch.empty((b, m), device=feats.device, dtype=feats.dtype)
            for _ in range(n_out)]
    other = masks[1] if len(masks) > 1 else None
    ptrs = [_ptr(o) for o in outs] + [None] * (4 - n_out)
    _launch(public.__name__, public.launches, "fwd", _cuda_fns()[0],
            variant, _ptr(feats), _ptr(masks[0]), _ptr(other), *ptrs,
            b, m, feats.shape[2], 1.0 / temp, feats.device.index,
            torch.cuda.current_stream(feats.device).cuda_stream)
    return tuple(outs)


def _slices(m, b):
    """(slices, column tiles per slice) of the fused backward at M = m and
    batch b: the fewest slices that give the grid ``_TARGET_BLOCKS`` blocks,
    from m and b alone, so a shape always sums in the same order."""
    tiles = -(-m // _TILE)
    want = min(tiles, -(-_TARGET_BLOCKS // (tiles * b)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _bwd_fused(variant, feats, masks, temp, cts, out, slices, per, mx=None):
    """The fused backward kernel: ``out`` is the gradient when ``slices`` is
    1, else the (slices, B, M, C) partials. ``mx``: V2's row max."""
    b, m, c = feats.shape
    public, _ = _public(variant)
    other = masks[1] if len(masks) > 1 else None
    gptr = [_ptr(g) for g in cts] + [None] * (3 - len(cts))
    _launch(public.__name__, public.launches, "bwd", _cuda_fns()[1],
            variant, _ptr(feats), _ptr(masks[0]), _ptr(other), *gptr,
            _ptr(mx), _ptr(out), slices, per, b, m, c, 1.0 / temp,
            feats.device.index,
            torch.cuda.current_stream(feats.device).cuda_stream)


def _bwd_reduce(variant, part, grad):
    """grad = the sum of the slices' partials, in slice order."""
    public, _ = _public(variant)
    _launch(public.__name__, public.launches, "bwd_reduce", _cuda_fns()[2],
            _ptr(part), _ptr(grad), part.shape[0], grad.numel(),
            grad.device.index,
            torch.cuda.current_stream(grad.device).cuda_stream)


def _bwd(variant, feats, masks, temp, cts, mx=None):
    cts = [torch.zeros_like(masks[0]) if g is None else g.contiguous()
           for g in cts]
    _check_same(feats, *cts)
    b, m, _ = feats.shape
    slices, per = _slices(m, b)
    grad = torch.empty_like(feats)
    if slices == 1:
        _bwd_fused(variant, feats, masks, temp, cts, grad, 1, per, mx)
        return grad
    part = torch.empty((slices,) + tuple(feats.shape), device=feats.device,
                       dtype=feats.dtype)
    _bwd_fused(variant, feats, masks, temp, cts, part, slices, per, mx)
    _bwd_reduce(variant, part, grad)
    return grad


class GramRowStats(torch.autograd.Function):
    """``gram_row_stats`` on the card: forward and backward kernels."""

    @staticmethod
    def forward(ctx, feats, pos_mask, other_mask, temp):
        ctx.temp = temp
        ctx.save_for_backward(feats, pos_mask, other_mask)
        return _fwd(_ROW, feats, (pos_mask, other_mask), temp)

    @staticmethod
    def backward(ctx, g_pos, g_other, g_tot):
        feats, pos_mask, other_mask = ctx.saved_tensors
        grad = _bwd(_ROW, feats, (pos_mask, other_mask), ctx.temp,
                    (g_pos, g_other, g_tot))
        return grad, None, None, None


class GramLogitStats(torch.autograd.Function):
    """``gram_logit_stats`` on the card: forward and backward kernels."""

    @staticmethod
    def forward(ctx, feats, pos_mask, temp):
        ctx.temp = temp
        ctx.save_for_backward(feats, pos_mask)
        return _fwd(_LOGIT, feats, (pos_mask,), temp)

    @staticmethod
    def backward(ctx, g_lsum, g_tot):
        feats, pos_mask = ctx.saved_tensors
        grad = _bwd(_LOGIT, feats, (pos_mask,), ctx.temp, (g_lsum, g_tot))
        return grad, None, None


class GramSupconV2Stats(torch.autograd.Function):
    """``gram_supcon_v2_stats`` on the card: forward and backward kernels;
    the row max is an output without gradient."""

    @staticmethod
    def forward(ctx, feats, pos_mask, neg_mask, temp):
        ctx.temp = temp
        outs = _fwd(_V2, feats, (pos_mask, neg_mask), temp)
        ctx.mark_non_differentiable(outs[0])
        ctx.save_for_backward(feats, pos_mask, neg_mask, outs[0])
        return outs

    @staticmethod
    def backward(ctx, g_mx, g_ps, g_ns, g_tot):
        feats, pos_mask, neg_mask, mx = ctx.saved_tensors
        grad = _bwd(_V2, feats, (pos_mask, neg_mask), ctx.temp,
                    (g_ps, g_ns, g_tot), mx)
        return grad, None, None, None


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _check_same(feats, *arrays):
    for a in arrays:
        if a.dtype != torch.float32 or a.device != feats.device:
            raise TypeError(f"gram: every tensor must be float32 on "
                            f"{feats.device} (got {a.dtype} on {a.device})")
        if a.shape != feats.shape[:2] or not a.is_contiguous():
            raise ValueError(f"gram: masks and cotangents must be contiguous "
                             f"{tuple(feats.shape[:2])}, got "
                             f"{tuple(a.shape)}")


def _prepare(feats, masks):
    """Check the inputs and give them a batch axis. Returns (feats, masks,
    squeeze) with feats (B, M, C) and masks (B, M)."""
    if feats.dim() not in (2, 3):
        raise ValueError(f"gram: feats must be (M, C) or (B, M, C), got "
                         f"{tuple(feats.shape)}")
    squeeze = feats.dim() == 2
    if squeeze:
        feats = feats[None]
        masks = tuple(mk[None] for mk in masks)
    if feats.dtype != torch.float32:
        raise TypeError(f"gram: feats must be float32, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("gram: feats must be contiguous")
    _check_same(feats, *masks)
    if feats.device.type == "cuda":
        c = feats.shape[2]
        if c > _MAX_C or c % 4:
            raise ValueError(f"the gram kernels take C <= {_MAX_C} with "
                             f"C % 4 == 0, got C={c}")
        if any(t.data_ptr() % 16 for t in (feats, *masks)):
            raise ValueError("gram: tensors must be 16-byte aligned")
    elif feats.device.type != "cpu":
        raise ValueError(f"gram runs on cuda or cpu, not {feats.device}")
    return feats, masks, squeeze


def _unbatch(outs, squeeze):
    return tuple(o[0] for o in outs) if squeeze else outs


def gram_row_stats(feats, pos_mask, other_mask, temp):
    """(pos_sum, other_sum, total_sum) of e = exp(l), see the module doc.

    feats (M, C) or (B, M, C) float32, L2-normalized; masks (M,) or (B, M).
    Outputs have the masks' shape."""
    feats, masks, squeeze = _prepare(feats, (pos_mask, other_mask))
    if feats.device.type == "cpu":
        outs = gram_row_stats_plain(feats, *masks, temp)
    else:
        outs = GramRowStats.apply(feats, *masks, float(temp))
    return _unbatch(outs, squeeze)


gram_row_stats.launches = {"fwd": 0, "bwd": 0, "bwd_reduce": 0}


def gram_logit_stats(feats, pos_mask, temp):
    """(logit_pos_sum, total_sum) of the masked logits l, see the module
    doc. Shapes as in :func:`gram_row_stats`."""
    feats, masks, squeeze = _prepare(feats, (pos_mask,))
    if feats.device.type == "cpu":
        outs = gram_logit_stats_plain(feats, *masks, temp)
    else:
        outs = GramLogitStats.apply(feats, *masks, float(temp))
    return _unbatch(outs, squeeze)


gram_logit_stats.launches = {"fwd": 0, "bwd": 0, "bwd_reduce": 0}


def gram_supcon_v2_stats(feats, pos_mask, neg_mask, temp):
    """(row_max, pos_sims, neg_sims, tot) of the raw-feature sims, see the
    module doc; ``row_max`` carries no gradient. Shapes as in
    :func:`gram_row_stats`."""
    feats, masks, squeeze = _prepare(feats, (pos_mask, neg_mask))
    if feats.device.type == "cpu":
        outs = gram_supcon_v2_stats_plain(feats, *masks, temp)
    else:
        outs = GramSupconV2Stats.apply(feats, *masks, float(temp))
    return _unbatch(outs, squeeze)


gram_supcon_v2_stats.launches = {"fwd": 0, "bwd": 0, "bwd_reduce": 0}
