"""Few-shot (task ``fs``) training: constrained k-means over pixel
embeddings — port of ``cet_pick_tpu/train/fewshot.py``.

Rebuild of the reference's few-shot pathway
(trains/tomo_fewshot_cr_trainer.py:20-168 via models/loss.py:871-935 and
models/kmeans.py:32+):

* ``kmeans_vmf_loss``    — cosine-softmax of pixel embeddings against the
  cluster prototypes, cross-entropy against the constrained k-means labels
  (loss.py:871-905)
* ``partial_sup_loss``   — supervised contrastive loss over the labeled
  embeddings only (loss.py:907-935); supervised ``tomo`` training uses it
  too
* ``constrained_kmeans`` / ``constrained_kmeans_warm`` — Lloyd iterations
  with the labeled pixels pinned to their class's cluster (MPKMeans with
  hard seeds); a fixed number of iterations on the device, no host sync
* ``make_fewshot_train_step`` / ``train_fewshot`` — the TomoKMTrainer loop
  (tomo_fewshot_cr_trainer.py:38-134): every step clusters the projection
  pixels with warm-started constrained k-means, then optimizes vmf +
  cr_weight * partial supcon; the prototypes are carried through the run
* ``fewshot_similarity`` — inference: cosine similarity of every voxel to
  the target-class prototype, decodable with ``ops/decode.tomo_decode``

JAX pins the similarity and prototype products to ``Precision.HIGHEST``
(fewshot.py:43-49). The port's counterpart is a float32 product with TF32
off: ``train_fewshot`` sets that (``infer/detector.set_float32_precision``)
and refuses to run on the card with TF32 on.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from cet_pick_tpu_torch.data.prefetch import PrefetchIterator
from cet_pick_tpu_torch.infer.detector import set_float32_precision
from cet_pick_tpu_torch.infer.tiled import check_untiled_fits
from cet_pick_tpu_torch.train.metrics import LaggedMetrics
from cet_pick_tpu_torch.train.state import (
    AsyncCheckpointer,
    checkpoint_payload,
)

SUP_MAX = 256  # cap of labeled pixels in the supervised term (fewshot.py:159)
LLOYD_ITERS = 30


def top_k_stable(score, k):
    """``lax.top_k`` along the last axis: the k largest, ties broken by the
    lower index (``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _normalize(x, dim=-1):
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(1e-12)


def _one_hot(labels, k, dtype):
    """``jax.nn.one_hot``: a label outside [0, k) gives a zero row."""
    return (labels[:, None] == torch.arange(k, device=labels.device)).to(dtype)


def kmeans_vmf_loss(embeddings, labels, prototypes, temp=0.07):
    """-mean log p(label | embedding) under a cosine-softmax over prototypes
    (fewshot.py:56-69). embeddings (N, C), labels (N,) int, prototypes
    (K, C); the row max is detached."""
    u = _normalize(embeddings)
    v = _normalize(prototypes)
    sim = torch.matmul(u, v.T) / temp
    sim = sim - sim.detach().amax(1, keepdim=True)
    e = torch.exp(sim)
    one_hot = _one_hot(labels, prototypes.shape[0], e.dtype)
    num = (e * one_hot).sum(1)
    den = e.sum(1)
    prob = num / den.clamp_min(1e-12)
    return -torch.log(prob.clamp_min(1e-12)).mean()


def partial_sup_loss(embeddings, gt_labels, temp=0.07):
    """Supervised contrastive loss over labeled rows (fewshot.py:72-95).

    embeddings (..., N, C); gt_labels (..., N) integers, > 0 marks a labeled
    row and rows sharing a label attract. Returns one loss per leading
    index (a scalar for (N, C)). A weight mask, not a boolean gather, keeps
    the shapes static; the row max is detached."""
    dt = embeddings.dtype
    lbl = gt_labels
    valid = (lbl > 0).to(dt)
    sims = torch.matmul(embeddings, embeddings.transpose(-1, -2)) / temp
    n = sims.shape[-1]
    eye = torch.eye(n, dtype=dt, device=embeddings.device)
    offdiag = (1 - eye) * valid[..., :, None] * valid[..., None, :]
    same = (lbl[..., :, None] == lbl[..., None, :]).to(dt) * offdiag

    sims = sims - sims.detach().amax(-1, keepdim=True)
    denom = (torch.exp(sims) * offdiag).sum(-1)
    log_prob = sims - torch.log(torch.clamp(denom, min=1e-12))[..., None]
    pos_count = torch.clamp(same.sum(-1), min=1.0)
    mean_log_prob = (same * log_prob).sum(-1) / pos_count
    row_has_pos = (same.sum(-1) > 0).to(dt)
    return -(mean_log_prob * row_has_pos).sum(-1) / torch.clamp(
        row_has_pos.sum(-1), min=1.0)


def _lloyd_constrained(x, seed_labels, cents, n_clusters, max_iter):
    """Lloyd iterations with labeled points pinned to their class's cluster
    (fewshot.py:98-117): cosine affinity, the first index among equal
    maxima, and a cluster left empty keeps its old centre. x (N, C)
    normalized; returns (centres (K, C), assignments (N,))."""
    seeded = seed_labels > 0

    def assign_of(cents):
        free = torch.argmax(torch.matmul(x, _normalize(cents).T), dim=1)
        return torch.where(seeded, seed_labels, free)

    for _ in range(max_iter):
        oh = _one_hot(assign_of(cents), n_clusters, x.dtype)
        cnt = oh.sum(0)[:, None]
        cents = torch.where(cnt > 0,
                            torch.matmul(oh.T, x) / cnt.clamp_min(1.0), cents)
    return cents, assign_of(cents)


def constrained_kmeans(embeddings, seed_labels, n_clusters=4,
                       max_iter=LLOYD_ITERS):
    """Must-link constrained k-means (fewshot.py:120-140): seed_labels (N,)
    int, 0 = unlabeled, c >= 1 = must stay in cluster c. The initial
    centres are the label classes' means (label 0 too), and data rows
    where a class has no member. Returns (prototypes (K, C), assignments
    (N,))."""
    n = embeddings.shape[0]
    x = _normalize(embeddings)
    one_hot = _one_hot(seed_labels, n_clusters, x.dtype)
    counts = one_hot.sum(0)[:, None]
    idx = torch.arange(n_clusters, device=x.device) % n
    cents = torch.where(counts > 0,
                        torch.matmul(one_hot.T, x) / counts.clamp_min(1.0),
                        x[idx])
    return _lloyd_constrained(x, seed_labels, cents, n_clusters, max_iter)


def constrained_kmeans_warm(embeddings, seed_labels, init_centers,
                            max_iter=LLOYD_ITERS):
    """Lloyd iterations resumed from the previous step's prototypes
    (fewshot.py:143-152; reference tomo_fewshot_cr_trainer.py:104-107)."""
    x = _normalize(embeddings)
    return _lloyd_constrained(x, seed_labels, init_centers,
                              init_centers.shape[0], max_iter)


def fewshot_loss(model, batch, centers, config):
    """The fs step's forward (fewshot.py:166-199): (loss, centres,
    assignments, metrics). ``batch``: ``input`` (B, D, H, W) and ``lb_map``
    (B, D, H', W') tensors; ``centers`` (K, C)."""
    out = model(batch["input"])
    proj = out["proj"]                      # (B, D, H', W', C)
    feats = _normalize(proj.reshape(-1, proj.shape[-1]))
    seeds = batch["lb_map"].reshape(-1).to(torch.int64)
    cents, assign = constrained_kmeans_warm(feats.detach(), seeds, centers)
    vmf = kmeans_vmf_loss(feats, assign, cents, temp=config.temp)
    # supervised contrastive over (up to SUP_MAX) labeled pixels; the stable
    # top-k puts labeled rows first in index order, as lax.top_k does
    k = min(SUP_MAX, feats.shape[0])
    _, top = top_k_stable((seeds > 0).to(feats.dtype), k)
    sup = partial_sup_loss(feats[top], seeds[top], temp=config.temp)
    loss = vmf + config.cr_weight * sup
    return loss, cents, assign, {"loss": loss, "vmf_loss": vmf,
                                 "sup_loss": sup}


def make_fewshot_train_step(model, config):
    """``step(state, batch, centers) -> (centers, metrics)``: one train-mode
    forward, warm constrained k-means, vmf + cr_weight * partial supcon,
    backward and one Adam step (fewshot.py:162-208). The returned centres
    carry no gradient."""

    def step(state, batch, centers):
        model.train()
        loss, cents, _, metrics = fewshot_loss(model, batch, centers, config)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return cents, {k: v.detach() for k, v in metrics.items()}

    return step


def init_fewshot_centers(model, batch, n_clusters):
    """Cold-start prototypes from the first batch, an eval forward
    (fewshot.py:211-222; mpkmeans_with_initial_labels)."""
    model.eval()
    with torch.no_grad():
        proj = model(batch["input"])["proj"]
    feats = _normalize(proj.reshape(-1, proj.shape[-1]))
    seeds = batch["lb_map"].reshape(-1).to(torch.int64)
    cents, _ = constrained_kmeans(feats, seeds, n_clusters=n_clusters)
    return cents


def train_fewshot(config, dataset, num_epochs=None, log_fn=print,
                  prepared=None, device="cuda"):
    """Epoch loop of the fs task (fewshot.py:225-301): ``--load_model``
    applied before the cold centres, resume from the restored epoch,
    ``--num_iters`` as a per-epoch cap, ``model_last.pth`` with
    ``cluster_centers.npy`` beside it every epoch and, with ``--save_all``,
    ``model_<epoch>.pth``. One device (JAX excludes fs from data
    parallelism too). Returns (state, centers (K, C) numpy, history)."""
    from cet_pick_tpu_torch.train.refine import prepare_refine

    set_float32_precision(config.dtype)
    n_clusters = max(int(config.nclusters), 3)  # bg=0, target=1, other=2
    if prepared is None:
        prepared = prepare_refine(config, log_fn=log_fn, device=device)
    model, state, device = (prepared["model"], prepared["state"],
                            prepared["device"])
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the fs task needs full-f32 products (JAX's "
                           "Precision.HIGHEST): TF32 is on")
    rng = np.random.default_rng(config.seed)
    # JAX draws this batch for its model init: it is drawn here too, so that
    # the epochs' draws follow in the same stream
    batch0 = dataset.sample_batch(
        rng, range(min(config.batch_size, len(dataset))))
    centers = init_fewshot_centers(
        model, {k: torch.from_numpy(v).to(device) for k, v in batch0.items()},
        n_clusters)

    step = make_fewshot_train_step(model, config)
    num_epochs = num_epochs or config.num_epochs
    cap = config.num_iters if config.num_iters >= 0 else None
    history = []
    with AsyncCheckpointer() as ckpt:
        for epoch in range(state.epoch + 1, num_epochs + 1):
            epoch_metrics = []
            drain = LaggedMetrics()

            def collect(m):
                if m is not None:
                    epoch_metrics.append(m)

            t_first = None  # host clock when step 1 had finished
            # the cap applies before the prefetch, so that no batch past it
            # is drawn from the stream
            with PrefetchIterator(itertools.islice(
                    dataset.epoch_batches(rng, config.batch_size), cap),
                    device=device) as batches:
                for batch in batches:
                    centers, metrics = step(state, batch, centers)
                    collect(drain.push(metrics))
                    if t_first is None:
                        collect(drain.pop())
                        t_first = time.perf_counter()
            collect(drain.pop())
            t_end = time.perf_counter()
            if not epoch_metrics:
                raise ValueError(
                    f"no training batches: {len(dataset)} samples < "
                    f"batch_size {config.batch_size}"
                    + (" (--num_iters 0 caps every epoch at zero batches)"
                       if config.num_iters == 0 else ""))
            state.epoch = epoch
            means = {k: float(np.mean([m[k] for m in epoch_metrics]))
                     for k in epoch_metrics[0]}
            history.append(means)
            log_fn(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.5f}" for k, v in means.items()))
            if len(epoch_metrics) > 1:
                rate = ((len(epoch_metrics) - 1) * config.batch_size
                        / (t_end - t_first))
                log_fn(f"epoch {epoch}: steps {len(epoch_metrics)}, after "
                       f"the first {rate:.4f} samples/s")
            if config.save_dir:
                snap = ckpt.save(os.path.join(config.save_dir,
                                              "model_last.pth"),
                                 checkpoint_payload(state), config)
                os.makedirs(config.save_dir, exist_ok=True)
                np.save(os.path.join(config.save_dir, "cluster_centers.npy"),
                        centers.cpu().numpy())
                if config.save_all and (config.val_intervals <= 0
                                        or epoch % config.val_intervals == 0):
                    ckpt.save(os.path.join(config.save_dir,
                                           f"model_{epoch}.pth"),
                              snap, config, snapshotted=True)
    return state, centers.cpu().numpy(), history


def fewshot_similarity(model, centers, volume, target_cluster=1,
                       xy_budget=None):
    """Per-voxel cosine similarity to the target-class prototype
    (fewshot.py:304-315; trainer save_results,
    tomo_fewshot_cr_trainer.py:285-293): one untiled eval forward of the
    whole (D, H, W) volume (numpy or a tensor), as JAX runs it; raises
    ``MemoryError`` where
    that forward cannot fit (``infer/tiled.check_untiled_fits``). Returns
    the (D, H', W') score volume on the model's device."""
    device = next(model.parameters()).device
    if not isinstance(volume, torch.Tensor):
        volume = np.asarray(volume, np.float32)
    volume = torch.as_tensor(volume, dtype=torch.float32, device=device)
    check_untiled_fits(model, volume.shape, device, xy_budget=xy_budget)
    model.eval()
    with torch.no_grad():
        proj = _normalize(model(volume[None], active_heads=("proj",))
                          ["proj"][0])                   # (D, H', W', C)
        proto = _normalize(torch.as_tensor(
            np.asarray(centers), dtype=proj.dtype, device=device)
            [target_cluster])
        return torch.einsum("dhwc,c->dhw", proj, proto)
