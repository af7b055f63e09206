"""SCAN semantic clustering: neighbour mining -> SCAN loss -> self-labeling —
port of ``cet_pick_tpu/train/scan.py`` (tasks ``scan`` / ``scan2d3d``).

* neighbour mining by exact kNN over the pretext (SimSiam) embeddings on the
  device (``ops/kmeans.knn_search``; reference utils/memory_bank.py:44-85
  used FAISS);
* ``scan_loss`` — loss.py:87-119: the BCE pull of the anchor / neighbour
  softmax similarity towards 1, minus an entropy bonus on the mean cluster
  distribution (weight 2.0) against collapse;
* ``confidence_ce_loss`` — loss.py:15-66: the self-labeling cross-entropy of
  strongly augmented views against confident (p > threshold) weak-view
  pseudo-labels, with optional inverse-frequency class balance;
* ``ClusteringHead`` over fixed features and the full-model fine-tune of
  ``models/simsiam.ScanClusteringModel`` (simsiam_model_2d3d.py:847-877,
  trains/tomo_scan_trainer.py:17-103, base_trainer.py:59-109);
* the SCAN evaluation helpers (trains/eval_utils.py:9-74).

The optimizer is the port's Adam with optax's float32 decay rates
(``train/state.TrainState``); every trained parameter takes part in every
step (a parameter the loss does not reach gets a zero gradient), as optax
updates the whole tree, so Adam's moments and step count are JAX's. Batch
indices and the host-side strong augmentation come from one
``np.random.default_rng(seed)`` in JAX's order, so the batches are JAX's.
Under a process group the fine-tune and self-labeling steps are
data-parallel, as JAX's ``auto_dp_step`` makes them (scan.py:391-456): each
rank draws the global batch's indices and keeps its rows, the entropy
term's batch mean and the self-labeling counts are the global batch's, and
the gradients are averaged over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cet_pick_tpu_torch.models.flax_init import flax_init_
from cet_pick_tpu_torch.models.simsiam import create_scan_model
from cet_pick_tpu_torch.ops.kmeans import knn_search
from cet_pick_tpu_torch.parallel import dist as D
from cet_pick_tpu_torch.train.state import TrainState, _merge_tolerant


def entropy_of_mean(probs, eps=1e-8):
    """Entropy of the batch-mean cluster distribution (scan.py:29-32); the
    global batch's mean in a data-parallel step."""
    if D.is_synced():
        mean = D.global_sum(probs.sum(0)) / D.global_count(probs.shape[0])
    else:
        mean = torch.mean(probs, dim=0)
    return -torch.sum(mean * torch.log(mean + eps))


def scan_loss(anchor_logits, neighbor_logits, entropy_weight=2.0, eps=1e-8):
    """(total, consistency, entropy) — scan.py:35-43, loss.py:94-119."""
    pa = F.softmax(anchor_logits, dim=1)
    pn = F.softmax(neighbor_logits, dim=1)
    sim = torch.sum(pa * pn, dim=1)
    consistency = -torch.mean(torch.log(torch.clamp(sim, eps, 1.0)))
    ent = entropy_of_mean(pa, eps)
    return consistency - entropy_weight * ent, consistency, ent


def confidence_ce_loss(weak_logits, strong_logits, threshold=0.99,
                       class_balance=True):
    """Masked self-labeling CE (scan.py:46-64, loss.py:15-66). Returns
    (loss, n_confident); the counts and sums are the global batch's in a
    data-parallel step."""
    probs = F.softmax(weak_logits, dim=1)
    max_prob = torch.amax(probs, dim=1)
    target = torch.argmax(probs, dim=1)  # the first index of a tie
    mask = (max_prob > threshold).to(probs.dtype)
    n = D.global_sum(torch.sum(mask))
    if class_balance:
        one_hot = F.one_hot(target, weak_logits.shape[1]).to(probs.dtype)
        counts = D.global_sum((one_hot * mask[:, None]).sum(dim=0))
        freq = torch.where(counts > 0, n / counts.clamp_min(1.0),
                           torch.ones_like(counts))
        w = freq[target]
    else:
        w = torch.ones_like(max_prob)
    logp = F.log_softmax(strong_logits, dim=1)
    ce = -torch.gather(logp, 1, target[:, None])[:, 0]
    num, den = D.global_sums(torch.sum(ce * w * mask), torch.sum(w * mask))
    return num / den.clamp_min(1.0), n


class ClusteringHead(nn.Linear):
    """The linear cluster head over fixed trunk features (scan.py:67-77,
    one head as ``train_scan_head`` builds it), with flax's ``Dense``
    initializers."""

    def __init__(self, in_features: int, n_clusters: int):
        super().__init__(in_features, n_clusters)
        flax_init_(self)


def mine_neighbors(embeddings, k=20, block=1024, device="cuda"):
    """Top-k neighbour indices (N, k), self excluded by index, not by rank
    (scan.py:80-95: with tied embeddings another point can rank ahead of
    the anchor itself). Peak memory O(block * N)."""
    x = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    n = x.shape[0]
    _, idx = knn_search(x, x, k=min(k, n - 1), block=block,
                        exclude_self=True)
    return idx.cpu().numpy()


def _apply_gradients(state, loss):
    """Backward and one Adam step over every trained parameter, those the
    loss does not reach with a zero gradient (optax updates the whole tree:
    their Adam moments decay and their step count advances, as in JAX).
    In a data-parallel step the gradients are averaged over the ranks."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    D.allreduce_grads(state.trained_parameters())
    for p in state.trained_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1


def train_scan_head(features, neighbors, n_clusters, num_steps=200,
                    batch_size=128, lr=1e-3, entropy_weight=2.0, seed=0,
                    log_fn=print, device="cuda", head=None):
    """Train a clustering head over fixed pretext features with the SCAN
    objective (scan.py:105-150; trains/tomo_scan_trainer.py:17-100 with the
    trunk frozen). features (N, D) float32, neighbors (N, k) indices.
    ``head``: a ``ClusteringHead`` to start from (default: drawn from
    ``seed``). Returns (state, head, cluster assignments)."""
    features = np.asarray(features, np.float32)
    n = len(features)
    if head is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            head = ClusteringHead(features.shape[1], n_clusters)
    head.to(device)
    state = TrainState(head, lr)
    feats = torch.from_numpy(features).to(device)
    rng = np.random.default_rng(seed)
    k = neighbors.shape[1]
    for it in range(num_steps):
        idx = rng.integers(0, n, size=min(batch_size, n))
        nb = neighbors[idx, rng.integers(0, k, size=len(idx))]
        anchor = feats[torch.from_numpy(idx).to(device)]
        neighbor = feats[torch.from_numpy(nb).to(device)]
        total, cons, ent = scan_loss(head(anchor), head(neighbor),
                                     entropy_weight)
        _apply_gradients(state, total)
        if (it + 1) % 50 == 0:
            metrics = {"loss": total, "consistency": cons, "entropy": ent}
            log_fn(f"scan step {it + 1}: " + " ".join(
                f"{kk}={float(v.detach()):.4f}" for kk, v in metrics.items()))
    with torch.no_grad():
        logits = head(feats)
    # int32, as JAX's argmax gives it
    assign = torch.argmax(logits, dim=1).to(torch.int32)
    return state, head, assign.cpu().numpy()


def scan_evaluate(assignments, neighbors):
    """Fraction of mined neighbours sharing the anchor's cluster
    (scan.py:153-158, eval_utils.py:40-74)."""
    a = np.asarray(assignments)
    same = a[neighbors] == a[:, None]
    return float(same.mean())


# ---------------------------------------------------------------------------
# full-model SCAN fine-tune + confidence self-labeling
# (TomoSCANTrainer, trains/tomo_scan_trainer.py:17-103 +
#  base_trainer.py:59-109 ModelWithLossSCAN{,2D3D})
# ---------------------------------------------------------------------------

def load_pretext_backbone(state, simsiam_state_dict):
    """Graft a trained SimSiam encoder's weights into the clustering
    model's backbone (scan.py:192-228) by the tolerant merge of
    ``train/state.py`` (state.py:262-284): the entries whose names and
    shapes match are taken, the encoder's extra ``pred`` head is ignored,
    and a shape-mismatched entry keeps its initial value with a message."""
    backbone = state.model.backbone
    backbone.load_state_dict(
        _merge_tolerant(backbone.state_dict(), simsiam_state_dict),
        strict=True)
    return state


def make_scan_finetune_step(model, entropy_weight=2.0, head_only=False):
    """``step(state, a2d, a3d, n2d, n3d) -> metrics`` over (anchor,
    neighbour) patch batches (B, 1, H, W) (scan.py:231-290).

    head_only=False fine-tunes the whole network (the reference's default,
    ModelWithLossSCAN :77-79): two train-mode forwards, anchor then
    neighbour, the second seeing the BatchNorm statistics the first
    updated. head_only=True is --cluster_head (base_trainer.py:62-77): the
    backbone runs in eval mode without gradients, so its parameters and
    statistics stay bit-identical, and only the cluster heads learn. The
    loss is the sum of the heads' SCAN losses; ``head_losses`` holds each."""

    def step(state, a2d, a3d, n2d, n3d):
        with D.synced():
            if head_only:
                model.eval()
                with torch.no_grad():
                    fa = model.features(a2d, a3d)
                    fn = model.features(n2d, n3d)
            else:
                model.train()
                fa = model.features(a2d, a3d)
                fn = model.features(n2d, n3d)
            totals, cons, ents = zip(*(
                scan_loss(la, ln, entropy_weight) for la, ln in
                zip(model.head_logits(fa), model.head_logits(fn))))
            head_losses = torch.stack(totals)
            loss = head_losses.sum()
            _apply_gradients(state, loss)
            return D.mean_metrics({
                "total_loss": loss.detach(),
                "consistency_loss": torch.stack(cons).mean().detach(),
                "entropy_loss": torch.stack(ents).mean().detach(),
                "head_losses": head_losses.detach()})

    return step


def make_selflabel_step(model, threshold=0.99, class_balance=True, head=0):
    """``step(state, w2d, w3d, s2d, s3d) -> metrics``: confident weak-view
    pseudo-labels supervise the strong view (scan.py:293-323, loss.py:15-66)
    through cluster head ``head``. The weak view goes through the eval-mode
    forward, detached; the strong view through a train-mode forward."""

    def step(state, w2d, w3d, s2d, s3d):
        model.eval()
        with torch.no_grad():
            weak = model(w2d, w3d)[head]
        model.train()
        with D.synced():
            strong = model.head_logits(model.features(s2d, s3d))[head]
            loss, n_conf = confidence_ce_loss(
                weak, strong, threshold=threshold,
                class_balance=class_balance)
            _apply_gradients(state, loss)
            return D.mean_metrics({"loss": loss.detach(),
                                   "n_confident": n_conf.detach()})

    return step


def _strong_aug(rng, x):
    """Host-side strong augmentation for self-labeling (scan.py:326-335):
    random flips + gaussian noise, on (N, H, W) patches. The draws and the
    result are JAX's on its (N, H, W, 1) layout."""
    y = x.copy()
    for i in range(len(y)):
        if rng.random() < 0.5:
            y[i] = y[i][:, ::-1]
        if rng.random() < 0.5:
            y[i] = y[i][::-1, :]
    return y + rng.standard_normal(y.shape).astype(np.float32) * 0.1


def _patch_stack(patches):
    x = np.asarray(patches, np.float32)
    if x.ndim != 3:
        raise ValueError(f"patches must be (N, H, W), got {x.shape}")
    return x


def scan_assignments(model, patches_2d, patches_3d, batch_size=256, head=0,
                     device="cuda"):
    """Cluster assignment (the argmax of ``head``, the SCAN stage's best
    head) of every (N, H, W) patch, eval mode (scan.py:338-356). Returns
    (assignments, logits) as numpy."""
    p2 = torch.from_numpy(_patch_stack(patches_2d))
    p3 = None if patches_3d is None else \
        torch.from_numpy(_patch_stack(patches_3d))
    model.eval()
    out = []
    with torch.no_grad():
        for s in range(0, len(p2), batch_size):
            x2 = p2[s:s + batch_size, None].to(device)
            x3 = None if p3 is None else p3[s:s + batch_size, None].to(device)
            out.append(model(x2, x3)[head])
    logits = torch.cat(out).cpu().numpy()
    return logits.argmax(axis=1), logits


def train_scan_full(config, patches_2d, patches_3d, neighbors, n_clusters,
                    n_heads=1, pretext=None, num_steps=300, batch_size=64,
                    lr=1e-4, entropy_weight=2.0, head_only=False,
                    selflabel_steps=0, selflabel_threshold=0.99, seed=0,
                    log_fn=print, device="cuda", init=None):
    """The SCAN pipeline over candidate patches (scan.py:359-463).

    patches_2d / patches_3d: (N, H, W) float32 stacks (patches_3d None in
    2d mode); neighbors: (N, k) mined indices. pretext: a trained
    SimSiamEncoder state dict grafted into the backbone. init: a state dict
    of the clustering model to start from (default: drawn from ``seed``).
    selflabel_steps > 0 adds the confidence self-labeling round through the
    SCAN stage's best head. With n_heads > 1 the heads train together and
    the best is the argmin of the per-head loss over the last min(50,
    num_steps) steps (tomo_scan_trainer.py:66-76), accumulated on the
    device and fetched once. Returns (state, model, assignments,
    best_head)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_scan_model(config, n_clusters, n_heads)
    if init is not None:
        model.load_state_dict(init, strict=True)
    model.to(device)
    # Adam (scan.py:173-189); its lr stays settable, as inject_hyperparams
    # keeps it (train/state.set_learning_rate)
    state = TrainState(model, lr)
    if pretext is not None:
        state = load_pretext_backbone(state, pretext)
    p2 = _patch_stack(patches_2d)
    p3 = None if patches_3d is None else _patch_stack(patches_3d)
    x2 = torch.from_numpy(p2).to(device)
    x3 = None if p3 is None else torch.from_numpy(p3).to(device)

    def views(idx):
        # under a process group: this rank's rows of the global batch
        i = torch.from_numpy(D.local_rows(idx)).to(device)
        return x2[i, None], (None if x3 is None else x3[i, None])

    step = make_scan_finetune_step(model, entropy_weight, head_only=head_only)
    D.check_batch_split(min(batch_size, len(p2)))
    rng = np.random.default_rng(seed)
    n, k = len(p2), neighbors.shape[1]
    tail = max(1, min(50, num_steps))
    head_sums, head_cnt = None, 0
    for it in range(num_steps):
        idx = rng.integers(0, n, size=min(batch_size, n))
        nb = neighbors[idx, rng.integers(0, k, size=len(idx))]
        metrics = step(state, *views(idx), *views(nb))
        if num_steps - it <= tail:
            hl = metrics["head_losses"]
            head_sums = hl if head_sums is None else head_sums + hl
            head_cnt += 1
        if (it + 1) % 50 == 0:
            log_fn(f"scan step {it + 1}: " + " ".join(
                f"{kk}={float(v):.4f}" for kk, v in metrics.items()
                if v.dim() == 0))
    head_sums = (head_sums.cpu().numpy() if head_sums is not None
                 else np.zeros(n_heads))
    mean_losses = head_sums / max(head_cnt, 1)
    best_head = int(np.argmin(mean_losses))
    if n_heads > 1:
        log_fn(f"best cluster head: {best_head} (mean losses "
               + " ".join(f"{v:.4f}" for v in mean_losses) + ")")

    if selflabel_steps > 0:
        sl_step = make_selflabel_step(model, threshold=selflabel_threshold,
                                      head=best_head)
        for it in range(selflabel_steps):
            idx = rng.integers(0, n, size=min(batch_size, n))
            w2d, w3d = views(idx)
            s2d = torch.from_numpy(D.local_rows(
                _strong_aug(rng, p2[idx]))).to(device)
            s3d = None if p3 is None else torch.from_numpy(D.local_rows(
                _strong_aug(rng, p3[idx]))).to(device)
            metrics = sl_step(state, w2d, w3d, s2d[:, None],
                              None if s3d is None else s3d[:, None])
            if (it + 1) % 50 == 0:
                log_fn(f"selflabel step {it + 1}: " + " ".join(
                    f"{kk}={float(v):.4f}" for kk, v in metrics.items()))

    assign, _ = scan_assignments(model, p2, p3, head=best_head,
                                 device=device)
    return state, model, assign, best_head
