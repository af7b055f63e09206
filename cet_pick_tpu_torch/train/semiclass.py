"""Semiclass training: fill/unfill voxel crops through the refinement step —
port of ``cet_pick_tpu/train/semiclass.py``.

The reference's semiclass trainer (cet_pick/trains/
tomo_cr_semi_class_trainer.py:18-121) has the semi task's objective,

    loss = hm_loss + cr_weight * contrastive + consistency
    hm_loss = focal (--pn) | PU-GE (--ge, the reference's production choice)

applied to voxel-centric crops whose targets come from the discrete
fill/unfill label volumes (data/classify_dataset.py). The step is the semi
task's (train/refine.make_train_step), which folds the pair axis of the
(B, 1, D, H, W) batch; the ``label`` key travels along unused, as in JAX.
So on the card the row gram kernels (``--ge``) or the logit ones (``--pn``)
run at semiclass's own shape, (B, 2 x 6 x 32 x 32, head_conv).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cet_pick_tpu_torch.parallel import dist as D
from cet_pick_tpu_torch.train.refine import (
    make_train_step,
    make_val_step,
    prepare_refine,
    run_epoch,
)
from cet_pick_tpu_torch.train.state import (
    AsyncCheckpointer,
    checkpoint_payload,
)


def check_semiclass_config(config):
    """Refuse the plain PU risk, which semiclass does not define
    (semiclass.py:32-40, tomo_cr_semi_class_trainer.py:25-36). The CLI calls
    it before any device set-up, and ``train_semiclass`` again."""
    if not (config.pn or config.ge):
        raise ValueError(
            "semiclass requires --pn (focal) or --ge (PU-GE); the plain PU "
            "risk estimator is not defined for this task "
            "(tomo_cr_semi_class_trainer.py:25-36)"
        )


def train_semiclass(config, dataset, val_dataset=None, num_epochs=None,
                    log_fn=print, prepared=None, device="cuda"):
    """Epoch loop for the semiclass task (semiclass.py:43-119):
    ``model_last.pth`` after every epoch; every ``val_intervals`` epochs plain focal on each
    validation volume against its label volume with the -1s set to 0
    (:107-115), and with ``--save_all`` ``model_<epoch>.pth``. JAX keeps no
    best checkpoint here, and neither does the port. Under a process group
    rank 0 alone validates and writes. Returns (state, history)."""
    check_semiclass_config(config)
    if prepared is None:
        prepared = prepare_refine(config, log_fn=log_fn, device=device)
    model, state = prepared["model"], prepared["state"]
    device = prepared["device"]
    train_step = make_train_step(model, config)
    rng = np.random.default_rng(config.seed)
    val_step = make_val_step(model) if val_dataset is not None else None

    num_epochs = num_epochs or config.num_epochs
    history = []
    with AsyncCheckpointer() as ckpt:
        for epoch in range(state.epoch + 1, num_epochs + 1):
            history.append(run_epoch(train_step, state, dataset, rng, config,
                                     epoch, device, log_fn))
            snap = ckpt.save(os.path.join(config.save_dir, "model_last.pth"),
                             checkpoint_payload(state), config)
            if (val_step is not None and config.val_intervals > 0
                    and epoch % config.val_intervals == 0 and D.is_main()):
                vals = []
                for i in range(len(val_dataset.names)):
                    item = val_dataset.val_item(i)
                    gt = np.where(item["hm"] < 0, 0.0, item["hm"])
                    loss, _ = val_step(
                        state, torch.from_numpy(item["input"]).to(device),
                        torch.from_numpy(gt.astype(np.float32)).to(device))
                    vals.append(float(loss))
                log_fn(f"epoch {epoch}: val_focal={np.mean(vals):.5f}")
                if config.save_all:
                    ckpt.save(os.path.join(config.save_dir,
                                           f"model_{epoch}.pth"),
                              snap, config, snapshotted=True)
    return state, history
