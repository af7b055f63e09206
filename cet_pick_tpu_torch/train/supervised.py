"""Supervised training for the ``tomo`` and ``cr`` tasks — port of
``cet_pick_tpu/train/supervised.py``.

The reference's two supervised baselines (reference
cet_pick/trains/tomo_cr_trainer.py:17-76 and tomo_trainer.py:17-107):

* ``cr``   — focal heatmap loss + ``cr_weight`` x the single-view pixel
             supcon (SupConLossV2, loss.py:821-868), no second view;
* ``tomo`` — focal heatmap loss + ``cr_weight`` x a supervised contrastive
             pull between up to ``GATHER_K`` gathered positive and negative
             pixels (temperature 0.2).

Both train on RefineDataset crops in pn mode (``--pn`` is required). The
``cr`` gram runs through ``ops/gram.gram_supcon_v2_stats``: the CUDA
kernels for a tensor on the card, the plain blocked version on the CPU,
with the batch as a leading axis in place of JAX's ``lax.map`` / ``vmap``.

The JAX step reshapes the heatmap to ``h // 2`` (supervised.py:147), so
these tasks run the stride-2 ``unet_N`` only; ``train_supervised`` rejects
``unetw_N`` rather than add a combination JAX does not have.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cet_pick_tpu_torch.ops.gram import gram_supcon_v2_stats
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.train import losses as L
from cet_pick_tpu_torch.train.fewshot import (
    partial_sup_loss,
    top_k_stable,
)
from cet_pick_tpu_torch.train.refine import (
    optimizer_step,
    prepare_refine,
    run_epoch,
)
from cet_pick_tpu_torch.train.state import AsyncCheckpointer, checkpoint_payload

GATHER_K = 128  # static positive/negative gather size of the tomo task


def supcon_v2_loss(feats, hm, temp=0.07, thresh=0.5):
    """Single-view pixel supcon (supervised.py:41-85), per sample.

    feats (B, N, C) pixel projections, taken as they are (raw dot
    products); hm (B, N) targets. Positive pixels (hm > thresh) attract
    each other, negative pixels (hm < thresh) each other; each row is
    softmax-normalized over all other pixels. Assembled from the gram
    stats as JAX's Pallas path does (:66-71):
    (log_prob * mask).sum(1) = masked_sims_sum - (rowmax + log tot) * mask.sum().
    Returns (B,)."""
    dt = feats.dtype
    pos = (hm > thresh).to(dt)
    neg = (hm < thresh).to(dt)
    n_pos = torch.clamp(pos.sum(-1), min=1.0)
    n_neg = torch.clamp(neg.sum(-1), min=1.0)
    mx, psims, nsims, tot = gram_supcon_v2_stats(
        feats.contiguous(), pos.contiguous(), neg.contiguous(), temp)
    base = mx + torch.log(torch.clamp(tot, min=1e-12))
    mean_pos_rows = (psims - base * pos.sum(-1, keepdim=True)) / n_pos[:, None]
    mean_neg_rows = (nsims - base * neg.sum(-1, keepdim=True)) / n_neg[:, None]
    loss_pos = -(mean_pos_rows * pos).sum(-1) / n_pos
    loss_neg = -(mean_neg_rows * neg).sum(-1) / n_neg
    return loss_pos + loss_neg


def tomo_site_supcon(feats, hm, ties=None, generator=None, temp=0.2,
                     thresh=0.5):
    """Gathered-site supcon for the tomo task (supervised.py:88-120), per
    sample: feats (B, N, C), hm (B, N) -> (B,).

    Gathers up to GATHER_K positive (hm > thresh) and GATHER_K negative
    pixels into one labeled set and applies ``partial_sup_loss``; rows the
    gather could not fill carry label 0. Which members are gathered is
    drawn at random: ``ties`` gives the (tie_p, tie_n) uniforms, each
    (B, N), or else ``generator`` draws them (tie_p, then tie_n). With
    neither, the first members by index are taken, as JAX does with
    ``key=None``."""
    k = min(GATHER_K, feats.shape[-2])
    pos = hm > thresh
    neg = hm <= thresh
    if ties is None and generator is not None:
        ties = torch.rand((2,) + tuple(hm.shape), generator=generator,
                          device=hm.device, dtype=hm.dtype)
    if ties is None:
        tie_p = tie_n = torch.zeros_like(hm)
    else:
        tie_p, tie_n = ties
    zero = torch.zeros((), dtype=hm.dtype, device=hm.device)
    pv, pi = top_k_stable(torch.where(pos, 1.0 + tie_p, zero), k)
    nv, ni = top_k_stable(torch.where(neg, 1.0 + tie_n, zero), k)
    idx = torch.cat([pi, ni], dim=-1)
    f = torch.take_along_dim(feats, idx[..., None], dim=-2)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                        min=1e-12)
    labels = torch.cat([torch.where(pv > 0, 1, 0), torch.where(nv > 0, 2, 0)],
                       dim=-1)
    return partial_sup_loss(f, labels, temp=temp)


def make_supervised_train_step(model, config, task, generator=None):
    """The tomo / cr step (supervised.py:123-191): one train-mode forward of
    one view, focal loss + ``cr_weight`` x the task's contrastive term,
    backward and one Adam step. ``generator`` draws the tomo task's gather
    ties. Returns ``train_step(state, batch)`` -> metrics on the device."""
    temp = config.temp
    thresh = config.thresh
    cr_weight = config.cr_weight
    contrastive = config.contrastive

    def loss_fn(batch):
        x = batch["input"]
        b, p, d, h, w = x.shape
        out = model(x.reshape(b * p, d, h, w))
        hm = sigmoid_clamped(out["hm"][..., 0]).reshape(b, p, d, h // 2,
                                                         w // 2)
        gt = batch["hm"]
        hm_loss = L.focal_loss(hm, gt)
        metrics = {"hm_loss": hm_loss}
        loss = hm_loss
        if contrastive:
            c = out["proj"].shape[-1]
            feats = out["proj"].reshape(b * p, -1, c)
            labels = gt.reshape(b * p, -1)
            if task == "cr":
                cr = supcon_v2_loss(feats, labels, temp=temp,
                                    thresh=thresh).mean()
            else:
                cr = tomo_site_supcon(feats, labels, generator=generator,
                                      temp=0.2, thresh=thresh).mean()
            metrics["cr_loss"] = cr
            loss = loss + cr * cr_weight
        metrics["loss"] = loss
        return loss, metrics

    return optimizer_step(model, loss_fn)


def train_supervised(config, dataset, num_epochs=None, log_fn=print,
                     prepared=None, device="cuda"):
    """Epoch loop of the tomo / cr tasks (supervised.py:194-278): LR steps,
    the ``--num_iters`` cap, write-behind ``model_last.pth`` and, with
    ``--save_all``, ``model_<epoch>.pth``. No validation. Returns (state,
    history)."""
    if config.task not in ("tomo", "cr"):
        raise ValueError(f"train_supervised handles tomo/cr, got "
                         f"{config.task!r}")
    if not config.pn:
        raise ValueError(
            "tomo/cr are fully supervised: run with --pn so the heatmap "
            "targets carry explicit negatives (tomo_trainer.py uses plain "
            "FocalLoss, no PU debiasing)")
    if config.arch.startswith("unetw"):
        raise ValueError(
            f"--task {config.task} trains the stride-2 unet_N only: its step "
            f"reads the heatmap at H/2 (cet_pick_tpu/train/supervised.py:147),"
            f" and {config.arch} outputs H/4")
    if prepared is None:
        prepared = prepare_refine(config, log_fn=log_fn, device=device)
    model, state = prepared["model"], prepared["state"]
    device = prepared["device"]
    rng = np.random.default_rng(config.seed)
    # JAX draws one batch from the seeded stream to initialize the model
    # (:213-214); the same draw keeps the port's batches JAX's
    dataset.sample_batch(rng, [0])
    generator = torch.Generator(device=device).manual_seed(config.seed + 1)
    train_step = make_supervised_train_step(model, config, config.task,
                                            generator=generator)
    num_epochs = num_epochs or config.num_epochs
    history = []
    with AsyncCheckpointer() as ckpt:
        for epoch in range(state.epoch + 1, num_epochs + 1):
            history.append(run_epoch(train_step, state, dataset, rng, config,
                                     epoch, device, log_fn))
            snap = ckpt.save(os.path.join(config.save_dir, "model_last.pth"),
                             checkpoint_payload(state), config)
            if config.save_all and (config.val_intervals <= 0
                                    or epoch % config.val_intervals == 0):
                ckpt.save(os.path.join(config.save_dir, f"model_{epoch}.pth"),
                          snap, config, snapshotted=True)
    return state, history
