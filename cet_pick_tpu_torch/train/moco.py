"""MoCo exploration training — port of ``cet_pick_tpu/train/moco.py``.

Rebuild of reference cet_pick/models/moco.py:12-151 + moco_main.py +
trains/tomo_moco_trainer.py:17-84:

* query encoder = the SimSiam trunk + fc + proj head (models/simsiam.py);
  the key encoder is a copy that needs no gradient, its parameters an EMA
  of the query's (m = 0.999), its BatchNorm running statistics the query's
  from before each step (moco.py:160-206);
* a queue of r = 1024 L2-normalized keys, (r, dim) as in JAX, and its
  pointer; r is rounded down to the enqueue block (B, or 2B under
  ``--moco_symmetric``, moco.py:274-276);
* InfoNCE: l_pos = q . k+, l_neg = q . queue, temperature 0.1, target
  class 0 (moco.py:136-145); plain SGD as ``optax.sgd``.

The step's order is JAX's: the views (query strong, key
``strong=symmetric``); the key EMA from the pre-step query parameters,
before the key forward; the key forward in eval mode on its running
statistics; the query's ``encode`` + ``proj`` in train mode (``pred`` never
runs, so its BN statistics stay put); the SGD step; the key's BN buffers
set to the query's pre-step ones; the keys enqueued in float32.

Intended deviations from JAX: the queue's initial draws come from a
``torch.Generator`` seeded with ``seed`` (JAX: ``fold_in(PRNGKey(seed),
1)``). Under a process group the step is data-parallel as JAX's
``auto_dp_step`` makes it (:func:`moco_update`).
Checkpoints are ``model_last.pth``: ``state_dict`` holds ``encoder_q.*``,
``encoder_k.*``, ``queue`` and ``queue_ptr`` (the reference MoCo wrapper's
names), beside ``epoch``, ``step`` and ``optimizer``, with ``opt.json``.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.io.flax_msgpack import (
    MOCO_CHECKPOINT_FILE,
    is_checkpoint_dir,
    read_checkpoint,
)
from cet_pick_tpu_torch.models.convert import (
    load_simsiam_checkpoint,
    read_any_checkpoint,
    simsiam_state_dict_from_jax,
)
from cet_pick_tpu_torch.models.simsiam import create_simsiam
from cet_pick_tpu_torch.parallel import dist as D
from cet_pick_tpu_torch.train.explore import (
    explore_augment,
    norm_stats,
    simsiam_lr_at_epoch,
    split_views,
    with_warmup,
)
from cet_pick_tpu_torch.train.refine import run_epoch
from cet_pick_tpu_torch.train.state import AsyncCheckpointer, TrainState

MOMENTUM = 0.999
TEMPERATURE = 0.1
QUEUE_SIZE = 1024


class MoCoState(TrainState):
    """The query encoder and its SGD (``TrainState``), the key encoder, the
    queue (r, dim) and its pointer (JAX ``MoCoState``, moco.py:37-47)."""

    def __init__(self, model, key_model, queue, lr: float):
        super().__init__(model, lr, optimizer=torch.optim.SGD(
            model.parameters(), lr=lr))
        self.key_model = key_model
        self.queue = queue
        self.queue_ptr = 0


def moco_queue_size(config, r=QUEUE_SIZE) -> int:
    """r rounded down to a multiple of the enqueue block, B or 2B under
    ``--moco_symmetric``, and at least one block (moco.py:274-276)."""
    blk = config.batch_size * (2 if config.moco_symmetric else 1)
    return max(blk, r - r % blk)


def init_queue(r, dim, seed, device):
    """(r, dim) standard normal rows, L2-normalized, drawn on the host from
    a generator seeded with ``seed`` (so the card and the CPU start from
    the same queue)."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(r, dim, generator=gen)
    return (q / q.norm(dim=1, keepdim=True)).to(device)


def _key_copy(model):
    key = copy.deepcopy(model)
    for p in key.parameters():
        p.requires_grad_(False)
    return key


def _unit(x):
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def embed_proj(model, x):
    """``proj(encode(x))`` of a batch of views (moco.py:120-130)."""
    return model.proj(model.encode(*split_views(x, model.mode)))


def moco_update(state: MoCoState, v_q, v_k, m=MOMENTUM,
                temperature=TEMPERATURE, blocks=1):
    """One MoCo step on augmented views ``v_q`` / ``v_k`` (moco.py:
    166-206): key EMA, key forward, query forward + InfoNCE, SGD, key BN
    buffers, enqueue. Returns the metrics (``loss``, ``acc``) as device
    scalars.

    Under a process group the views are this rank's rows of each of
    ``blocks`` equal blocks (2 under ``--moco_symmetric``: [v1, v2]): the
    query's BatchNorm takes the global moments, the gradients are averaged
    over the ranks, and every rank enqueues the keys of all ranks, gathered
    block by block in rank order — the single-process queue. The key
    encoder runs in eval mode, and its EMA and buffers copy the replicated
    query, so it stays the same on every rank."""
    q_model, k_model = state.model, state.key_model
    pre_bn = {n: b.detach().clone() for n, b in q_model.named_buffers()}
    with torch.no_grad():
        # momentum update BEFORE the key forward, from the pre-step query
        for pk, pq in zip(k_model.parameters(), q_model.parameters()):
            pk.copy_(pk * m + pq * (1.0 - m))
        k_model.eval()
        keys = _unit(embed_proj(k_model, v_k))
    q_model.train()
    with D.synced():
        q = _unit(embed_proj(q_model, v_q))
        l_pos = (q * keys).sum(dim=1, keepdim=True)
        l_neg = q @ state.queue.T
        logits = torch.cat([l_pos, l_neg], dim=1) / temperature
        loss = (-logits[:, 0] + torch.logsumexp(logits, dim=1)).mean()
        acc = (logits.argmax(dim=1) == 0).float().mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        D.allreduce_grads(q_model.parameters())
        metrics = D.mean_metrics({"loss": loss.detach(), "acc": acc})
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        # the key's BN statistics: the query's from before this step
        for n, b in k_model.named_buffers():
            b.copy_(pre_bn[n])
        if D.world() > 1:  # every rank's keys, block by block
            keys = torch.cat([D.gather_rows(k)
                              for k in keys.chunk(blocks)])
        r, bsz = state.queue.shape[0], keys.shape[0]
        state.queue[state.queue_ptr:state.queue_ptr + bsz] = \
            keys.to(state.queue.dtype)
        state.queue_ptr = (state.queue_ptr + bsz) % r
    return metrics


def make_moco_train_step(config, norm_mean, norm_std, gen):
    """``train_step(state, batch)``: the views drawn and applied on the
    batch's device from ``gen`` (the anchor strong, the aug
    ``strong=--moco_symmetric``), then :func:`moco_update`; under
    ``--moco_symmetric`` queries [v1, v2] against keys [v2, v1]
    (moco.py:148-171). Under a process group ``batch`` is the global
    batch: the augments draw for all of it and each rank keeps its rows
    of each view."""
    symmetric = bool(config.moco_symmetric)

    def views(batch, mode):
        augment = explore_augment(mode)
        v_q = D.local_rows(augment(batch["anchor"], gen, norm_mean, norm_std,
                                 config.bbox, strong=True))
        v_k = D.local_rows(augment(batch["aug"], gen, norm_mean, norm_std,
                                 config.bbox, strong=symmetric))
        if symmetric:
            v_q, v_k = torch.cat([v_q, v_k]), torch.cat([v_k, v_q])
        return v_q, v_k

    def train_step(state, batch):
        return moco_update(state, *views(batch, state.model.mode),
                           blocks=2 if symmetric else 1)

    return train_step


def moco_payload(state: MoCoState) -> dict:
    """The ``.pth`` payload: the reference MoCo wrapper's state-dict names
    (``encoder_q.*``, ``encoder_k.*``, ``queue``, ``queue_ptr``) with the
    epoch, the step and the optimizer (moco.py:209-221)."""
    sd = {"encoder_q." + k: v for k, v in state.model.state_dict().items()}
    sd.update({"encoder_k." + k: v
               for k, v in state.key_model.state_dict().items()})
    sd["queue"] = state.queue
    sd["queue_ptr"] = torch.tensor(state.queue_ptr, dtype=torch.int64)
    return {"epoch": state.epoch, "step": state.step, "state_dict": sd,
            "optimizer": state.optimizer.state_dict()}


def _prefixed(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_moco(path, state: MoCoState, log_fn=print) -> MoCoState:
    """``--load_model`` into a fresh ``MoCoState`` (moco.py:235-298). A MoCo
    run's checkpoint — the port's ``.pth`` (``encoder_k.*`` and a queue of
    this run's shape) or JAX's ``moco_state.msgpack`` directory — restores
    every field: both encoders, the queue, its pointer, the epoch, the step
    and the optimizer. Any other encoder checkpoint that
    ``load_simsiam_checkpoint`` reads (a reference ``.pth``, a MoCo wrapper
    whose queue has another shape, a torchvision ResNet, a SimSiam run)
    sets the query, and the key restarts as its copy."""
    model, key = state.model, state.key_model
    device = state.queue.device
    if is_checkpoint_dir(path, MOCO_CHECKPOINT_FILE):
        p = read_checkpoint(path, MOCO_CHECKPOINT_FILE)
        model.load_state_dict(simsiam_state_dict_from_jax(
            p["params"], p.get("batch_stats") or {}), strict=True)
        key.load_state_dict(simsiam_state_dict_from_jax(
            p["key_params"], p.get("key_batch_stats") or {}), strict=True)
        queue, ptr = torch.from_numpy(np.array(p["queue"])), p["queue_ptr"]
        epoch, step, opt = p["epoch"], p["step"], None
    else:
        sd, payload = read_any_checkpoint(path)
        queue = sd.get("queue")
        if (queue is None or not any(k.startswith("encoder_k.") for k in sd)
                or tuple(queue.shape) != tuple(state.queue.shape)):
            model.load_state_dict(load_simsiam_checkpoint(
                path, fill=model.state_dict(), log_fn=log_fn), strict=True)
            key.load_state_dict(model.state_dict(), strict=True)
            return state
        model.load_state_dict(_prefixed(sd, "encoder_q."), strict=True)
        key.load_state_dict(_prefixed(sd, "encoder_k."), strict=True)
        ptr = sd["queue_ptr"]
        epoch, step = payload.get("epoch", 0), payload.get("step", 0)
        opt = payload.get("optimizer")
    if tuple(queue.shape) != tuple(state.queue.shape):
        raise ValueError(f"{path}: queue {tuple(queue.shape)}, this run's is "
                         f"{tuple(state.queue.shape)} (the same batch size "
                         f"and --moco_symmetric resume a MoCo run)")
    state.queue = queue.to(device=device, dtype=torch.float32)
    state.queue_ptr = int(ptr)
    state.epoch, state.step = int(epoch), int(step)
    if opt is not None:
        state.optimizer.load_state_dict(opt)
    return state


def prepare_moco(config, r=QUEUE_SIZE, log_fn=print, device="cuda"):
    """Model, key copy, queue, SGD and ``--load_model`` (moco.py:257-316)
    on ``device`` (the card unless the caller passes ``device="cpu"``); the
    encoder initialized from ``config.seed``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = create_simsiam(config)
    model.to(device)
    queue = init_queue(moco_queue_size(config, r), model.head_conv,
                       config.seed, device)
    state = MoCoState(model, _key_copy(model), queue, config.lr)
    if config.load_model:
        load_moco(config.load_model, state, log_fn=log_fn)
        log_fn(f"loaded checkpoint from {config.load_model} "
               f"(epoch {state.epoch})")
    return {"model": model, "state": state, "device": device}


def train_moco(config, dataset, prepared, log_fn=print):
    """The MoCo epoch loop (moco.py:319-402) on :func:`prepare_moco`'s
    state: the explore LR schedule and ``--warm`` ramp, the
    ``--num_iters`` cap, resume from the restored epoch, write-behind
    ``model_last.pth`` (``model_<epoch>.pth`` under ``--save_all``).
    Returns (state, history of the epochs' mean ``loss`` / ``acc``)."""
    model, state = prepared["model"], prepared["state"]
    device = prepared["device"]
    norm_mean, norm_std = norm_stats(dataset, model.mode, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed + 1)
    train_step = make_moco_train_step(config, norm_mean, norm_std, gen)
    rng = np.random.default_rng(config.seed)
    total_batches = max(len(dataset) // config.batch_size, 1)
    history = []
    with AsyncCheckpointer() as ckpt:
        for epoch in range(state.epoch + 1, config.num_epochs + 1):
            history.append(run_epoch(
                with_warmup(train_step, config, epoch, total_batches),
                state, dataset, rng, config, epoch, device, log_fn,
                lr=simsiam_lr_at_epoch(config, epoch), shard=False))
            if not config.save_dir:
                continue
            snap = ckpt.save(os.path.join(config.save_dir, "model_last.pth"),
                             moco_payload(state), config)
            if config.save_all and (config.val_intervals <= 0
                                    or epoch % config.val_intervals == 0):
                ckpt.save(os.path.join(config.save_dir, f"model_{epoch}.pth"),
                          snap, config, snapshotted=True)
    return state, history
