"""Voxel classifier training (task ``tcla``) — port of
``cet_pick_tpu/train/classify.py``.

The reference's experimental classifier pathway (main_class.py +
trains/tomo_classifier_trainer.py:17-46): a detector with a single
``class`` head trained with BCE against 0/1 voxel labels, on the
annotation-centred crops of ``RefineDataset`` in pn mode. The two crops of
a pair are folded into the batch of one train-mode forward. JAX's loop has
no validation, so the head's z-tap runs the torch form in training; and it
has no ``--num_iters`` cap (classify.py:113-121): an epoch is the
dataset's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.parallel.dist import global_sums
from cet_pick_tpu_torch.train.refine import (
    _forward_pair,
    optimizer_step,
    prepare_refine,
    run_epoch,
)
from cet_pick_tpu_torch.train.state import AsyncCheckpointer, checkpoint_payload


def _safe_mean(x, n):
    """``Σx / max(n, 1)`` with both taken over the global batch (every
    rank's rows in a data-parallel step, ``parallel/dist``)."""
    total, n = global_sums(x.sum(), n)
    return total / torch.clamp(n, min=1.0)


def bce_loss(pred, gt):
    """Binary cross-entropy over labelled voxels (gt >= 0); unlabelled (-1)
    ignored (classify.py:22-30). pred: probabilities in (0, 1)."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    labeled = (gt >= 0).to(pred.dtype)
    target = torch.clamp(gt, 0.0, 1.0)
    ll = target * torch.log(pred) + (1 - target) * torch.log(1 - pred)
    return -_safe_mean(ll * labeled, labeled.sum())


def make_classify_train_step(model, config):
    """The BCE step over paired crops (classify.py:37-73,
    tomo_classifier_trainer.py:25-38): one train-mode forward of the
    (B x P) crops, ``sigmoid_clamped`` on the ``class`` head, BCE over the
    labelled voxels and their accuracy at 0.5, Adam."""

    def loss_fn(batch):
        out = _forward_pair(model, batch["input"])
        prob = sigmoid_clamped(out["class"][..., 0])
        gt = batch["hm"]
        loss = bce_loss(prob, gt)
        labeled = gt >= 0
        acc = _safe_mean(((prob > 0.5) == (gt > 0.5)).float() * labeled,
                         labeled.sum().float())
        return loss, {"loss": loss, "acc": acc}

    return optimizer_step(model, loss_fn)


def train_classify(config, dataset, num_epochs=None, log_fn=print,
                   prepared=None, device="cuda"):
    """Epoch loop of the tcla task (classify.py:76-152, main_class.py:58-120):
    ``--load_model`` / ``--resume`` (``.pth`` or a JAX checkpoint
    directory), the learning rate fixed at ``--lr`` (JAX steps no decay
    here), full epochs, write-behind ``model_last.pth`` and with
    ``--save_all`` ``model_<epoch>.pth``. Returns (state, history)."""
    if prepared is None:
        prepared = prepare_refine(config, log_fn=log_fn, device=device)
    model, state = prepared["model"], prepared["state"]
    device = prepared["device"]
    rng = np.random.default_rng(config.seed)
    # JAX draws one batch from the seeded stream to initialize the model
    # (:86-87); the same draw keeps the port's batches JAX's
    dataset.sample_batch(rng, [0])
    train_step = make_classify_train_step(model, config)
    num_epochs = num_epochs or config.num_epochs
    history = []
    with AsyncCheckpointer() as ckpt:
        for epoch in range(state.epoch + 1, num_epochs + 1):
            history.append(run_epoch(train_step, state, dataset, rng, config,
                                     epoch, device, log_fn, lr=config.lr,
                                     num_iters=False))
            if not config.save_dir:
                continue
            snap = ckpt.save(os.path.join(config.save_dir, "model_last.pth"),
                             checkpoint_payload(state), config)
            if config.save_all and (config.val_intervals <= 0
                                    or epoch % config.val_intervals == 0):
                ckpt.save(os.path.join(config.save_dir, f"model_{epoch}.pth"),
                          snap, config, snapshotted=True)
    return state, history
