"""Refinement training: PU focal + debiased contrastive + flip consistency —
port of ``cet_pick_tpu/train/refine.py``.

The reference's ``main.py semi`` with ``TomoCRSemiTrainer`` (reference:
cet_pick/trains/tomo_cr_semi_trainer.py:17-121):

    loss = hm_loss + cr_weight * (debiased_sup + 0.1 * debiased_unsup) + consis
    hm_loss = PU focal (default) | focal (--pn) | GE PU (--ge)
    both views forwarded through the model; the aug view's feature maps and
    heatmap are un-flipped by flip_prob before the contrastive and
    consistency terms (tomo_cr_semi_trainer.py:67-92)
    validation uses plain focal on whole volumes (:57-60)

Samples carry per-sample flip flags and are un-flipped with a ``torch.where``
over the batch, so any batch size works. The contrastive losses take the
batch as a leading axis (train/losses.py); on the card their gram row
statistics run the CUDA kernels of ``ops/gram.py``, forward and backward.

JAX's ``prepare_refine`` overlaps XLA compilation with the dataset build on
a thread and warms the step on a zeros batch; neither exists for an eager
PyTorch step. Its data-parallel mesh is a process group here
(``parallel/``): :func:`optimizer_step` averages the gradients over the
ranks and :func:`run_epoch` hands each rank its rows.
"""

from __future__ import annotations

import itertools
import json
import os
import time

import numpy as np
import torch

from cet_pick_tpu_torch.data.prefetch import PrefetchIterator
from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.parallel import dist as D
from cet_pick_tpu_torch.train import losses as L
from cet_pick_tpu_torch.train.metrics import LaggedMetrics
from cet_pick_tpu_torch.train.state import (
    AsyncCheckpointer,
    TrainState,
    checkpoint_payload,
    load_checkpoint,
    set_learning_rate,
)
from cet_pick_tpu_torch.utils.profiling import maybe_trace


def unflip_aug(x, flip_prob):
    """Undo per-sample flips on (B, P, D, H, W, ...) view-2 tensors
    (refine.py:38-47): flip_prob > 0.5 means the aug view was flipped along
    H (ud), else along W (lr). A flip is an involution, so the same helper
    makes the aug view from the input."""
    ud = torch.flip(x, dims=(3,))
    lr = torch.flip(x, dims=(4,))
    cond = (flip_prob > 0.5).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond, ud, lr)


def _forward_pair(model, x):
    """Apply the model to (B, P, D, H, W) paired crops by folding P into the
    batch (refine.py:50-73); outputs come back as (B, P, D, H', W', C)."""
    b, p, d, h, w = x.shape
    out = model(x.reshape(b * p, d, h, w))
    return {k: v.reshape((b, p) + v.shape[1:]) for k, v in out.items()}


def make_train_step(model, config):
    """The train step (refine.py:76-195): ``train_step(state, batch)`` runs
    two train-mode forwards (the second sees the BatchNorm statistics the
    first updated), the losses, backward and one Adam step, and returns the
    step's metrics as device scalars."""
    cr_weight = config.cr_weight
    tau = config.tau
    temp = config.temp
    thresh = config.thresh
    use_pn = config.pn
    use_ge = config.ge
    contrastive = config.contrastive

    def loss_fn(batch):
        out = _forward_pair(model, batch["input"])
        input_aug = unflip_aug(batch["input"], batch["flip_prob"])
        out_cr = _forward_pair(model, input_aug)

        hm = sigmoid_clamped(out["hm"][..., 0])         # (B, P, D, H', W')
        hm_cr = sigmoid_clamped(out_cr["hm"][..., 0])
        gt = batch["hm"]

        if use_pn:
            hm_loss = L.focal_loss(hm, gt)
            num_pos = D.global_sum((gt == 1).sum())
        elif use_ge:
            hm_loss = L.pu_ge_loss(hm, gt, tau=tau)
            num_pos = D.global_sum((gt == 1).sum())
        else:
            hm_loss, num_pos = L.pu_focal_loss(hm, gt, tau=tau)

        metrics = {"hm_loss": hm_loss, "num_pos": num_pos}
        loss = hm_loss

        if contrastive:
            flip = batch["flip_prob"]
            proj_cr = unflip_aug(out_cr["proj"], flip)
            hm_cr_unflipped = unflip_aug(hm_cr, flip)
            c = out["proj"].shape[-1]
            bsz = gt.shape[0]
            feats = out["proj"].reshape(bsz, -1, c)
            feats_cr = proj_cr.reshape(bsz, -1, c)
            labels = gt.reshape(bsz, -1)
            hm_flat = hm.reshape(bsz, -1)
            hm_cr_flat = hm_cr_unflipped.reshape(bsz, -1)
            if use_pn:
                cr = L.supcon_loss(labels, feats, feats_cr, temp=temp,
                                   thresh=thresh).mean()
            else:
                sup, unsup, _ = L.unbiased_con_loss(
                    labels, hm_flat, hm_cr_flat, feats, feats_cr, temp=temp,
                    tau_plus=tau, thresh=thresh)
                cr = (sup + 0.1 * unsup).mean()
            metrics["cr_loss"] = cr
            loss = loss + cr * cr_weight
            consis = L.consistency_loss(hm_flat, hm_cr_flat)
            metrics["consis_loss"] = consis
            loss = loss + consis

        metrics["loss"] = loss
        return loss, metrics

    return optimizer_step(model, loss_fn)


def optimizer_step(model, loss_fn):
    """``train_step(state, batch)``: ``loss_fn(batch) -> (loss, metrics)``
    in train mode, backward and one Adam step; returns the metrics as device
    scalars. Shared by the refinement, supervised, classify and exploration
    steps.

    Under a process group of several ranks (``parallel/dist``) ``batch`` is
    this rank's rows: the loss takes its global sums and BatchNorm moments
    over every rank, the gradients are averaged over the ranks before the
    step (DDP's reduction, :func:`parallel.dist.allreduce_grads`), and the
    metrics are the global batch's, so the step is one process's step over
    the global batch (JAX ``auto_dp_step``, mesh.py:107-128)."""

    def train_step(state, batch):
        model.train()
        with D.synced():
            loss, metrics = loss_fn(batch)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            D.allreduce_grads(model.parameters())
            metrics = D.mean_metrics(metrics)
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn  # the forward half, for timing by stage
    return train_step


def make_val_step(model):
    """Whole-volume validation: ``val_step(state, volume, gt_hm)`` returns
    the plain focal loss in eval mode (refine.py:198-210) and the clamped
    sigmoid heatmap it was taken on, which ``--debug`` decodes. On the card
    the head runs the z-tap kernel."""

    def val_step(state, volume, gt_hm):
        model.eval()
        with torch.no_grad():
            out = model(volume, active_heads=("hm",))
            hm = sigmoid_clamped(out["hm"][..., 0])
            return L.focal_loss(hm, gt_hm), hm

    return val_step


def lr_at_epoch(config, epoch):
    """Step decay: lr * decay^(#steps passed) (refine.py:213-219)."""
    lr = config.lr
    for step_epoch in config.lr_step:
        if epoch >= step_epoch:
            lr *= config.lr_decay_rate
    return lr


def prepare_refine(config, log_fn=print, device="cuda", freeze=()):
    """Model, train state and checkpoint load (refine.py:246-291): the
    detector initialized from ``config.seed``, Adam (``freeze``: top-level
    modules left out of it, ``train/state.TrainState``), and
    ``--load_model``, a ``.pth`` or a JAX checkpoint directory (with
    ``--resume``, the optimizer and epoch too). Under a process group the
    model goes to the rank's own card (``infer/detector.resolve_device``);
    every rank draws the same initial weights."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = create_detector(config)
    model.to(device)
    state = TrainState(model, config.lr, freeze=freeze)
    if config.load_model:
        load_checkpoint(config.load_model, state, resume=config.resume)
        log_fn(f"loaded checkpoint from {config.load_model} "
               f"(epoch {state.epoch})")
    return {"model": model, "state": state, "device": device}


def run_epoch(train_step, state, dataset, rng, config, epoch, device,
              log_fn=print, check=None, lr=None, num_iters=True,
              profile_dir=None, shard=True):
    """One epoch of ``train_step`` over ``dataset.epoch_batches``, shared by
    the refinement, supervised and exploration loops (refine.py:308-420,
    supervised.py:238-270, explore.py:243-342): the epoch's learning rate
    (``lr``, else the step decay's), the ``--num_iters``
    cap (``num_iters=False``: none, as tcla's loop has none), batches built
    and copied to the device by a producer thread, and metrics read one
    step late (train/metrics.py); ``check`` sees each step's metrics as
    they arrive. ``profile_dir``: trace the epoch there
    (``utils/profiling.maybe_trace``). Logs and returns the epoch's means,
    and logs the samples/s of the steps after the first.

    Under a process group every rank draws the same global batches from
    ``rng``; with ``shard`` each rank copies only its rows to its device
    (``parallel/dist.local_batch``), else the whole batch (a step whose
    device-side draws must see the global batch slices it itself).
    ``config.batch_size`` is the global batch."""
    D.check_batch_split(config.batch_size)
    set_learning_rate(state, lr_at_epoch(config, epoch) if lr is None else lr)
    epoch_metrics = []
    cap = config.num_iters if num_iters and config.num_iters >= 0 else None
    drain = LaggedMetrics()

    def collect(m):
        if m is not None:
            if check is not None:
                check(m)
            epoch_metrics.append(m)

    t_first = None  # host clock when step 1 had finished
    batches = dataset.epoch_batches(rng, config.batch_size)
    if shard:
        batches = map(D.local_batch, batches)
    with maybe_trace(profile_dir, cuda=torch.device(device).type == "cuda"), \
            PrefetchIterator(batches, device=device) as batches:
        for batch in itertools.islice(batches, cap):
            collect(drain.push(train_step(state, batch)))
            if t_first is None:
                # wait for step 1 once, so that the rate below covers the
                # steady steps only
                collect(drain.pop())
                t_first = time.perf_counter()
    collect(drain.pop())
    t_end = time.perf_counter()
    if not epoch_metrics:
        raise ValueError(
            f"no training batches: {len(dataset)} samples < batch_size "
            f"{config.batch_size} with drop_last — lower batch_size"
            + (" (--num_iters 0 caps every epoch at zero batches)"
               if config.num_iters == 0 else ""))
    state.epoch = epoch
    means = {k: float(np.mean([m[k] for m in epoch_metrics]))
             for k in epoch_metrics[0]}
    log_fn(f"epoch {epoch}: " + " ".join(
        f"{k}={v:.5f}" for k, v in means.items()))
    if t_first is not None and len(epoch_metrics) > 1:
        n = len(epoch_metrics) - 1
        log_fn(f"epoch {epoch}: steps {len(epoch_metrics)}, after the first "
               f"{n * config.batch_size / (t_end - t_first):.4f} samples/s")
    return means


def train_refine(config, dataset, val_dataset=None, num_epochs=None,
                 log_fn=print, prepared=None, device="cuda"):
    """Full training loop (refine.py:308-420): epochs, LR steps, the
    ``--num_iters`` cap, write-behind ``model_last.pth``, and every
    ``val_intervals`` epochs validation (with ``--debug > 0`` the overlays
    of :func:`debug_val_volume`), ``model_best.pth`` and, with
    ``--save_all``, ``model_<epoch>.pth``. Under a process group the ranks
    train together, and rank 0 alone validates and writes (the other ranks
    go on to the next epoch's first step, which waits for it). Returns
    (state, history)."""
    if prepared is None:
        prepared = prepare_refine(config, log_fn=log_fn, device=device)
    model, state = prepared["model"], prepared["state"]
    device = prepared["device"]
    train_step = make_train_step(model, config)
    rng = np.random.default_rng(config.seed)
    val_step = make_val_step(model) if val_dataset is not None else None

    num_epochs = num_epochs or config.num_epochs
    start_epoch = state.epoch + 1
    history = []

    def check_positives(m):
        # only the plain PU risk is undefined without positives (reference
        # loss.py:275-276); pn and ge tolerate it. Metrics are read one
        # step late, so the guard fires one step late and aborts the run.
        if not config.pn and not config.ge and m.get("num_pos", 1) == 0:
            raise ValueError(
                "batch contains no positive heatmap voxels — annotations "
                "missing or dropped (check --order and coordinate files)")

    # best-val tracking persists beside the checkpoints across --resume
    best_val = _load_best_val(config.save_dir) if config.resume else float("inf")
    with AsyncCheckpointer() as ckpt:
        for epoch in range(start_epoch, num_epochs + 1):
            # --profile_dir: the first epoch of the run (after a resume, the
            # first one it trains), as JAX traces it (refine.py:349-377)
            history.append(run_epoch(
                train_step, state, dataset, rng, config, epoch, device, log_fn,
                check_positives,
                profile_dir=config.profile_dir if epoch == start_epoch
                else None))
            snap = ckpt.save(os.path.join(config.save_dir, "model_last.pth"),
                             checkpoint_payload(state), config)
            if config.val_intervals > 0 and epoch % config.val_intervals == 0:
                if val_step is not None and D.is_main():
                    vals = []
                    for i in range(len(val_dataset.names)):
                        item = val_dataset.val_item(i)
                        loss, hm = val_step(
                            state, torch.from_numpy(item["input"]).to(device),
                            torch.from_numpy(item["hm"]).to(device))
                        vals.append(float(loss))
                        if config.debug > 0:
                            debug_val_volume(config, hm[0], item, epoch)
                    val_mean = float(np.mean(vals))
                    log_fn(f"epoch {epoch}: val_focal={val_mean:.5f}")
                    if val_mean < best_val:
                        best_val = val_mean
                        ckpt.save(os.path.join(config.save_dir,
                                               "model_best.pth"),
                                  snap, config, snapshotted=True)
                        _save_best_val(config.save_dir, best_val, epoch)
                if config.save_all:
                    ckpt.save(os.path.join(config.save_dir,
                                           f"model_{epoch}.pth"),
                              snap, config, snapshotted=True)
    return state, history


def debug_val_volume(config, hm, item, epoch):
    """``--debug`` on one validation item (refine.py:451-470): the clamped
    sigmoid heatmap of its eval forward with ``active_heads=("hm",)``
    (``hm``, (D, H', W'), the one its validation loss was taken on), decoded
    with ``--nms`` / ``--K``; every 4th slice's overlays and the detection
    txt under ``debug_dir/epoch{E}_{name}/`` (``utils/debugger.py``)."""
    from cet_pick_tpu_torch.ops.decode import tomo_decode
    from cet_pick_tpu_torch.utils.debugger import (
        Debugger,
        debug_validation_volume,
    )

    dets = tomo_decode(hm, kernel=config.nms, k=config.K).cpu().numpy()
    dbg = Debugger(os.path.join(config.debug_dir,
                                f"epoch{epoch}_{item['name']}"))
    debug_validation_volume(dbg, item["input"][0], hm.cpu().numpy(),
                            item["hm"][0], dets=dets)
    dbg.save_detection_txt(item["name"], dets, down_ratio=config.down_ratio)


def _best_val_path(save_dir):
    return os.path.join(save_dir, "best_val.json")


def _load_best_val(save_dir):
    """The best validation loss of earlier runs (refine.py:429-437)."""
    p = _best_val_path(save_dir)
    if os.path.exists(p):
        with open(p) as f:
            return float(json.load(f)["val"])
    return float("inf")


def _save_best_val(save_dir, val, epoch):
    os.makedirs(save_dir, exist_ok=True)
    with open(_best_val_path(save_dir), "w") as f:
        json.dump({"val": float(val), "epoch": int(epoch)}, f)
