"""Exploration (SimSiam) training — port of ``cet_pick_tpu/train/explore.py``
(the 2d3d and 2d patch modes and the 3D-subvolume ``vol`` mode).

Rebuild of reference cet_pick/simsiam_main.py:25-166 +
trains/tomo_simsiam_trainer.py:17-55:

* optimizer: plain SGD(lr), no momentum, no weight decay (simsiam_main.py:65
  — the lr*bs/256 value is computed there but unused; JAX ``optax.sgd``);
* per-epoch LR: cosine with eta_min = lr * decay^3, or step decay
  (utils/utils.py:58-70), and the per-batch ``--warm`` ramp;
* loss: symmetric negative cosine -(cos(p1, z2) + cos(p2, z1))/2 with
  stop-gradient z, plus the output-std collapse monitor
  (tomo_simsiam_trainer.py:28-40);
* the strong/weak augmentation pipelines run on the card inside the step
  (ops/augment.py), batched, from a ``torch.Generator`` seeded with
  ``seed + 1`` (JAX: ``PRNGKey(seed + 1)``; the draws' bits differ); vol
  mode draws both views from its one pipeline and ignores the dataset's
  statistics (each subvolume is z-normalized).

The epoch loop is the refinement one (``train/refine.run_epoch``: prefetched
batches with a pinned host -> device copy, metrics read one step late), and
checkpoints are ``model_last.pth`` (``model_<epoch>.pth`` under
``--save_all``) in the reference layout with ``opt.json``. JAX's
dataset/compile overlap thread and its zeros-batch warm step exist for XLA
and are not ported.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.models.convert import load_simsiam_checkpoint
from cet_pick_tpu_torch.models.simsiam import create_simsiam
from cet_pick_tpu_torch.ops.augment import (
    simsiam_augment,
    simsiam_augment_3d,
    simsiam_augment_vol,
)
from cet_pick_tpu_torch.parallel.dist import local_rows
from cet_pick_tpu_torch.train.losses import simsiam_loss
from cet_pick_tpu_torch.train.refine import optimizer_step, run_epoch
from cet_pick_tpu_torch.train.state import (
    AsyncCheckpointer,
    TrainState,
    checkpoint_payload,
    load_checkpoint,
    set_learning_rate,
)


def simsiam_lr_at_epoch(config, epoch):
    """Cosine or step LR (explore.py:64-73; utils/utils.py:58-70), as a
    Python float: the optimizer's state dict keeps it, and ``.pth`` files
    load with ``weights_only``, which refuses numpy scalars."""
    lr = config.lr
    if config.cosine:
        eta_min = lr * config.lr_decay_rate ** 3
        return float(eta_min + (lr - eta_min) * (
            1 + np.cos(np.pi * epoch / config.num_epochs)
        ) / 2)
    steps = int(np.sum(epoch > np.asarray(config.lr_step)))
    return lr * config.lr_decay_rate ** steps if steps > 0 else lr


WARM_EPOCHS = 10
WARMUP_FROM = 0.01


def simsiam_warmup_lr(config, epoch, batch_id, total_batches):
    """SupContrast-style per-batch linear LR warmup for --warm
    (explore.py:80-104; utils/utils.py:73-80 with warm_epochs/warmup_from/
    warmup_to set at opts.py:216-224): linear 0.01 -> warmup_to over the
    first 10 epochs. Returns the warm LR, or None outside the warm phase."""
    if not config.warm or epoch > WARM_EPOCHS:
        return None
    if config.cosine:
        eta_min = config.lr * config.lr_decay_rate ** 3
        warmup_to = eta_min + (config.lr - eta_min) * (
            1 + np.cos(np.pi * WARM_EPOCHS / config.num_epochs)
        ) / 2
    else:
        warmup_to = config.lr
    p = (batch_id + (epoch - 1) * total_batches) / (WARM_EPOCHS * total_batches)
    return float(WARMUP_FROM + p * (warmup_to - WARMUP_FROM))


def explore_augment(mode):
    """The augment pipeline of an exploration mode: the 2d3d one, the
    rec-only (2d) one of tomo_pre_proj_angle_select_new3d_vol.py, or the
    subvolume one (explore.py:131-143)."""
    return {"2d3d": simsiam_augment, "2d": simsiam_augment_3d,
            "vol": simsiam_augment_vol}[mode]


def split_views(x, mode):
    """A batch of views -> the encoder's (x2d, x3d) inputs: (B, C, H, W) ->
    (B, 1, H, W) tilt / slice patches (x3d only in 2d3d), or (B, D, H, W)
    subvolumes -> (B, 1, D, H, W) (explore.py:145-151)."""
    if mode == "vol":
        return x[:, None], None
    return x[:, 0:1], (x[:, 1:2] if mode == "2d3d" else None)


def make_simsiam_train_step(model, config, norm_mean, norm_std, gen):
    """``train_step(state, batch)``: both views augmented on the batch's
    device from ``gen`` (anchor strong, aug weak), the two-view forward in
    train mode, the loss, one SGD step (explore.py:107-163). ``norm_mean``
    / ``norm_std`` are the dataset's per-channel statistics as (C,) device
    tensors (unused in vol mode). The stages are exposed for timing:
    ``train_step.augment(batch) -> (v1, v2)`` and
    ``train_step.forward_loss(v1, v2)``. Under a process group ``batch``
    is the global batch: the augments draw for all of it, as one process
    would, and each rank forwards its rows of the views."""
    augment = explore_augment(model.mode)

    def augment_views(batch):
        return (augment(batch["anchor"], gen, norm_mean, norm_std,
                        config.bbox, strong=True),
                augment(batch["aug"], gen, norm_mean, norm_std, config.bbox,
                        strong=False))

    def forward_loss(v1, v2):
        ret1, ret2 = model(*split_views(v1, model.mode),
                           *split_views(v2, model.mode))
        loss, std = simsiam_loss(ret1["pred"], ret1["proj"], ret2["pred"],
                                 ret2["proj"])
        return loss, {"loss": loss, "std": std}

    def loss_fn(batch):
        # the draws are the global batch's (every rank holds it whole);
        # each rank keeps its rows of the views
        v1, v2 = augment_views(batch)
        return forward_loss(local_rows(v1), local_rows(v2))

    train_step = optimizer_step(model, loss_fn)
    train_step.augment = augment_views
    train_step.forward_loss = forward_loss
    return train_step


def prepare_explore(config, log_fn=print, device="cuda"):
    """Model, SGD state and checkpoint load (explore.py:180-240): the
    encoder initialized from ``config.seed``; ``--load_model`` takes what
    ``load_simsiam_checkpoint`` reads (the port's ``model_last.pth``, a
    reference ``.pth`` of the arch's family, a JAX checkpoint directory, a
    MoCo wrapper's query encoder, a torchvision ResNet as a trunk init),
    with ``--resume`` the optimizer and the epoch too. ``VolTrunk``
    (``simsiam_N`` / ``moco3d_N``) reads its own ``.pth``, which JAX, with
    no ``.pth`` layout for it, refuses (explore.py:205-217)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = create_simsiam(config)
    model.to(device)
    # optax.sgd: no momentum, no weight decay
    state = TrainState(model, config.lr, optimizer=torch.optim.SGD(
        model.parameters(), lr=config.lr))
    if config.load_model:
        model.load_state_dict(load_simsiam_checkpoint(
            config.load_model, fill=model.state_dict(), log_fn=log_fn),
            strict=True)
        if config.resume:
            load_checkpoint(config.load_model, state, resume=True)
        log_fn(f"loaded checkpoint from {config.load_model} "
               f"(epoch {state.epoch})")
    return {"model": model, "state": state, "device": device}


def norm_stats(dataset, mode, device):
    """The dataset's per-channel (mean, std) as (C,) tensors on ``device``:
    (tilt, slice) in 2d3d, the slice's alone otherwise."""
    stats = ((dataset.mean_2d, dataset.mean_3d), (dataset.std_2d,
                                                  dataset.std_3d))
    if mode != "2d3d":
        stats = ((dataset.mean_3d,), (dataset.std_3d,))
    return tuple(torch.tensor(s, dtype=torch.float32, device=device)
                 for s in stats)


def with_warmup(train_step, config, epoch, total_batches):
    """``train_step`` that first sets the ``--warm`` LR of its batch, in the
    warm epochs; ``train_step`` itself elsewhere."""
    if simsiam_warmup_lr(config, epoch, 0, total_batches) is None:
        return train_step
    batch_ids = itertools.count()

    def warm_step(state, batch):
        set_learning_rate(state, simsiam_warmup_lr(
            config, epoch, next(batch_ids), total_batches))
        return train_step(state, batch)

    return warm_step


def train_explore(config, dataset, prepared, log_fn=print):
    """Full exploration training loop (explore.py:243-342) on the model and
    state of :func:`prepare_explore`: per-epoch LR, the ``--num_iters``
    cap, write-behind ``model_last.pth``. Returns (state, history of the
    epochs' mean ``loss`` / ``std``)."""
    model, state = prepared["model"], prepared["state"]
    device = prepared["device"]
    norm_mean, norm_std = norm_stats(dataset, model.mode, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed + 1)
    train_step = make_simsiam_train_step(model, config, norm_mean, norm_std,
                                         gen)
    rng = np.random.default_rng(config.seed)

    total_batches = max(len(dataset) // config.batch_size, 1)
    history = []
    with AsyncCheckpointer() as ckpt:
        for epoch in range(state.epoch + 1, config.num_epochs + 1):
            history.append(run_epoch(
                with_warmup(train_step, config, epoch, total_batches),
                state, dataset, rng, config, epoch, device, log_fn,
                lr=simsiam_lr_at_epoch(config, epoch), shard=False))
            snap = ckpt.save(os.path.join(config.save_dir, "model_last.pth"),
                             checkpoint_payload(state), config)
            if (config.save_all and config.val_intervals > 0
                    and epoch % config.val_intervals == 0):
                ckpt.save(os.path.join(config.save_dir, f"model_{epoch}.pth"),
                          snap, config, snapshotted=True)
    return state, history
