"""Training objectives of refinement — port of ``cet_pick_tpu/train/losses.py``.

Same math as the JAX functions (reference cet_pick/models/loss.py):

* ``focal_loss``        — losses.py:65-86 (CornerNet penalty-reduced focal;
                          voxels labeled -1 excluded from the negative term)
* ``pu_focal_loss``     — losses.py:89-136 (non-negative positive-unlabeled
                          focal)
* ``pu_ge_loss``        — losses.py:139-176 (generalized-expectation PU,
                          ``--ge``); ``gammaln`` is ``torch.lgamma``
* ``unbiased_con_loss`` — losses.py:344-409 (debiased pixel contrastive
                          regularization over two views)
* ``supcon_loss``       — losses.py:480-511 (supervised contrastive, ``--pn``)
* ``consistency_loss``  — losses.py:518-520 (MSE between view heatmaps)
* ``simsiam_loss``      — losses.py:523-542 (exploration: symmetric negative
                          cosine with stop-gradient targets)

The two contrastive losses take a leading batch axis — labels (B, N),
features (B, N, C) — and return per-sample values (B,): the batch axis
replaces JAX's per-sample ``vmap`` / ``lax.map`` (refine.py:132-179). Their
(2N, 2N) similarity matrix is never materialized: the row statistics come
from ``ops/gram.py``, whose CUDA kernels run for a tensor on the card
(``_row_stats`` / ``_row_logit_stats``); a CPU tensor takes the plain
blocked version, each row block under ``torch.utils.checkpoint``. The
partner column (each pixel against its counterpart in the other view) is
O(M C) and computed outside the kernels, as JAX does (losses.py:329-334).

Data-dependent branches of the reference become ``torch.where`` with safe
denominators, as in JAX.

In a data-parallel step (``parallel/dist.synced``) each rank holds its rows
of the global batch. Every batch-wide count and sum that normalizes a loss
or decides a branch (the focal and PU losses, the GE count grid, the
SimSiam std monitor) is taken over all ranks by ``global_sums``; the
per-sample contrastive and consistency terms stay local means, whose
average over the equal shards is the global mean.
"""

from __future__ import annotations

import math

import torch

from cet_pick_tpu_torch.ops.gram import (
    gram_logit_stats,
    gram_logit_stats_plain,
    gram_row_stats,
    gram_row_stats_plain,
)
from cet_pick_tpu_torch.parallel.dist import (
    gather_rows,
    global_count,
    global_sums,
    is_synced,
)


def _safe_div(num, den):
    return num / torch.clamp(den, min=1.0)


# ---------------------------------------------------------------------------
# focal losses
# ---------------------------------------------------------------------------

def focal_loss(pred, gt):
    """CornerNet modified focal loss (losses.py:65-86) over all voxels.

    pred: probabilities in (0, 1) (already sigmoid-clamped); gt: 1 =
    positive, [0, 1) = labeled negative with (1-gt)^4 down-weighting, -1 =
    unlabeled (ignored)."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    pos = (gt == 1).to(pred.dtype)
    neg = ((gt > -1) & (gt < 1)).to(pred.dtype)
    neg_weights = torch.pow(1 - gt, 4)

    pos_loss = torch.log(pred) * torch.pow(1 - pred, 2) * pos
    neg_loss = torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * neg

    num_pos, pos_sum, neg_sum = global_sums(pos.sum(), pos_loss.sum(),
                                            neg_loss.sum())
    return torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))


def pu_focal_loss(pred, gt, tau=0.1, beta=0.0):
    """Non-negative positive-unlabeled focal loss (losses.py:89-136).

    gt: 1 = labeled positive, -1 = unlabeled, [0, 1) = soft negatives.
    Returns (loss, num_pos); the caller checks num_pos on the host (the
    reference raises when it is 0)."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    dt = pred.dtype
    true_pos = (gt == 1).to(dt)
    labeled = (gt > -1).to(dt)
    other = (gt < 1).to(dt)
    soft_pos = (labeled == other).to(dt)  # labeled negatives
    unlabeled = (gt == -1).to(dt)

    soft_pow_w = torch.pow(1 - gt, 4)
    soft_pow_neg_w = torch.pow(gt, 4)

    pos_loss = torch.log(pred) * torch.pow(1 - pred, 2) * true_pos
    soft_pos_loss = (torch.log(1 - pred) * torch.pow(pred, 2) * soft_pow_w
                     * soft_pos)
    neg_pos_loss = torch.log(1 - pred) * torch.pow(pred, 2) * true_pos
    neg_soft_pos_loss = (torch.log(pred) * torch.pow(1 - pred, 2)
                         * soft_pow_neg_w * soft_pos)
    unlabeled_neg = torch.pow(pred, 2) * torch.log(1 - pred) * unlabeled

    # every count and sum is the global batch's: the nnPU branch below is
    # decided on them
    (num_pos, num_unlabeled, num_soft, pos_sum, soft_pos_sum, neg_pos_sum,
     neg_soft_pos_sum, unlabeled_neg_sum) = global_sums(
        true_pos.sum(), unlabeled.sum(), soft_pos.sum(), pos_loss.sum(),
        soft_pos_loss.sum(), neg_pos_loss.sum(), neg_soft_pos_loss.sum(),
        unlabeled_neg.sum())

    pos_loss_tot = torch.where(
        num_soft > 0,
        -_safe_div(pos_sum, num_pos) - _safe_div(soft_pos_sum, num_soft),
        -_safe_div(pos_sum, num_pos),
    )
    pos_risk = pos_loss_tot * tau

    neg_pos_risk = torch.where(
        num_soft > 0,
        -_safe_div(neg_pos_sum, num_pos)
        - _safe_div(neg_soft_pos_sum, num_soft),
        -_safe_div(neg_pos_sum, num_pos),
    )

    unlabeled_risk = -_safe_div(unlabeled_neg_sum, num_unlabeled)

    neg_risk_total = -tau * neg_pos_risk + unlabeled_risk
    loss = torch.where(neg_risk_total < -beta, pos_risk,
                       pos_risk + neg_risk_total)
    return loss, num_pos


def pu_ge_loss(pred, gt, tau=0.1, slack=1.0, entropy_penalty=0.0):
    """Generalized-expectation PU loss (losses.py:139-176, ``--ge``): focal
    on labeled voxels + a penalty matching the count of positives among
    unlabeled voxels to Binomial(N, tau), over the static count grid
    0..V with entries > N masked."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    classifier_loss = focal_loss(pred, gt)

    unl = (gt == -1).to(pred.dtype)
    p = pred * unl
    n_unl, q_mu, q_var = global_sums(unl.sum(), p.sum(),
                                     (p * (1 - pred) * unl).sum())

    v = global_count(pred.shape[0])  # the global batch's count grid
    k = torch.arange(0, v + 1, dtype=pred.dtype, device=pred.device)
    valid = k <= n_unl
    q_logits = torch.where(valid, -0.5 * (q_mu - k) ** 2 / (q_var + 1e-7),
                           torch.tensor(-math.inf, dtype=pred.dtype,
                                        device=pred.device))
    q_discrete = torch.softmax(q_logits, dim=0)
    rest = torch.clamp(n_unl - k, min=0)
    log_binom = (torch.lgamma(n_unl + 1) - torch.lgamma(k + 1)
                 - torch.lgamma(rest + 1)
                 + k * math.log(tau) + rest * math.log1p(-tau))
    ge_penalty = -torch.sum(torch.where(valid, log_binom * q_discrete,
                                        torch.zeros_like(log_binom)))
    if entropy_penalty > 0:
        q_entropy = 0.5 * (torch.log(q_var + 1e-7) + math.log(2 * math.pi)
                           + 1)
        ge_penalty = ge_penalty + q_entropy * entropy_penalty
    return classifier_loss + slack * ge_penalty


# ---------------------------------------------------------------------------
# contrastive row statistics
# ---------------------------------------------------------------------------

def _partner_sims(feats_all, temp):
    """(B, 2N): f_i . f_partner(i) / T - 1/T, the partner being the same
    pixel in the other view (i +- N) — O(M C), outside the gram."""
    n = feats_all.shape[-2] // 2
    partner = torch.roll(feats_all, shifts=n, dims=-2)
    return (feats_all * partner).sum(-1) / temp - 1.0 / temp


def _row_stats_blocked(feats_all, pos_mask, other_mask, temp, block):
    """The plain row statistics (losses.py:183-249): (pos_sum, other_sum,
    total_sum, partner) of e = exp(l), each (B, 2N); blocks of ``block``
    rows, each under ``torch.utils.checkpoint``."""
    ps, os_, ts = gram_row_stats_plain(feats_all, pos_mask, other_mask, temp,
                                       block)
    return ps, os_, ts, torch.exp(_partner_sims(feats_all, temp))


def _row_stats(feats_all, pos_mask, other_mask, temp, block):
    """The CUDA kernel for a tensor on the card, the plain blocked version
    for one on the CPU (losses.py:314-335)."""
    if feats_all.device.type == "cuda":
        ps, os_, ts = gram_row_stats(feats_all, pos_mask, other_mask, temp)
        return ps, os_, ts, torch.exp(_partner_sims(feats_all, temp))
    return _row_stats_blocked(feats_all, pos_mask, other_mask, temp, block)


def _row_logit_stats_blocked(feats_all, pos_mask, temp, block):
    """The plain logit row statistics (losses.py:412-458):
    (logit_pos_sum, partner_logit, total_sum), each (B, 2N)."""
    lsum, tot = gram_logit_stats_plain(feats_all, pos_mask, temp, block)
    return lsum, _partner_sims(feats_all, temp), tot


def _row_logit_stats(feats_all, pos_mask, temp, block):
    """Dispatch by device like ``_row_stats`` (losses.py:461-477)."""
    if feats_all.device.type == "cuda":
        lsum, tot = gram_logit_stats(feats_all, pos_mask, temp)
        return lsum, _partner_sims(feats_all, temp), tot
    return _row_logit_stats_blocked(feats_all, pos_mask, temp, block)


# ---------------------------------------------------------------------------
# contrastive losses
# ---------------------------------------------------------------------------

def _calc_g(pos_mean, neg_mean, class_prob, temp):
    """Debiased negative estimate, clamped at e^(-1/T) (losses.py:338-341)."""
    ng = (neg_mean - class_prob * pos_mean) / (1 - class_prob)
    return torch.clamp(ng, min=math.e ** (-1.0 / temp))


def unbiased_con_loss(labels, out_hm, out_hm_cr, feats, feats_cr, temp=0.07,
                      tau_plus=0.1, thresh=0.5, block=1024):
    """Debiased contrastive regularization (losses.py:344-409), per sample.

    labels: (B, N) gt heatmap values; out_hm/out_hm_cr: (B, N) sigmoid
    heatmaps of the two views; feats/feats_cr: (B, N, C) L2-normalized
    pixel features of the two views (aug view un-flipped by the caller).

    Returns (debiased_loss_sup, debiased_loss_unsup, num_pos), each (B,).
    """
    n = labels.shape[-1]
    dt = feats.dtype
    feats_all = torch.cat([feats, feats_cr], dim=-2).contiguous()
    all_labels = torch.cat([labels, labels], dim=-1)
    all_preds = torch.cat([out_hm, out_hm_cr], dim=-1)

    if thresh < 1:
        pos_labels = (all_labels > thresh).to(dt)
    else:
        pos_labels = (all_labels == 1).to(dt)
    un_labels = (all_labels < 0).to(dt)
    other_inds = (all_labels < thresh).to(dt)

    num_pos_total = pos_labels.sum(-1)
    num_pos = num_pos_total / 2
    num_of_negatives = 2 * (n - num_pos)

    pos_sum, other_sum, total_sum, partner = _row_stats(
        feats_all, pos_labels, other_inds, temp, block)

    # supervised branch: rows with positive labels (loss.py:652-657)
    pos_feat_mean = pos_sum / torch.clamp(num_pos_total - 1, min=1.0)[:, None]
    rem_feat_mean = other_sum / torch.clamp(other_inds.sum(-1), min=1.0)[:, None]
    ng = _calc_g(pos_feat_mean, rem_feat_mean, tau_plus, temp)
    # a sample without positives (a semiclass crop drawn off the particles)
    # has pos_sum 0 on every row; its rows are masked out below, and a 1 in
    # place of their 0 keeps log(0) * 0 from making the loss and its
    # gradient NaN (JAX's XLA program gives 0 there)
    pos_feat_mean = torch.where(pos_labels > 0, pos_feat_mean,
                                torch.ones_like(pos_feat_mean))
    sup_rows = -torch.log(pos_feat_mean / (pos_feat_mean + ng))
    sup = _safe_div((sup_rows * pos_labels).sum(-1), num_pos_total)

    # unlabeled branch (loss.py:660-695)
    u_pos = partner
    u_rem = (total_sum - partner) / torch.clamp(num_of_negatives,
                                                min=1.0)[:, None]
    ng_pos = _calc_g(u_pos, u_rem, tau_plus, temp)
    ng_neg = _calc_g(u_pos, u_rem, 1 - tau_plus, temp)
    p = all_preds

    l_pos = -torch.log(u_pos / (u_pos + ng_pos)) * p
    l_neg = -torch.log(u_pos / (u_pos + ng_neg)) * (1 - p)

    m_pseudo_pos = un_labels * (p > 0.99)
    m_pseudo_neg = un_labels * (p < 0.01)
    m_mid = un_labels * (p >= 0.01) * (p <= 0.99)

    def masked_mean(x, m):
        return _safe_div((x * m).sum(-1), m.sum(-1))

    zero = torch.zeros((), dtype=dt, device=feats.device)
    term_pp = torch.where(m_pseudo_pos.sum(-1) > 0,
                          masked_mean(l_pos, m_pseudo_pos), zero)
    term_pn = torch.where(m_pseudo_neg.sum(-1) > 0,
                          masked_mean(l_neg, m_pseudo_neg), zero)
    term_mid = torch.where(m_mid.sum(-1) > 0,
                           masked_mean(l_pos, m_mid) + masked_mean(l_neg, m_mid),
                           zero)
    unsup = term_pp + term_pn + term_mid
    return sup, unsup, num_pos_total


def supcon_loss(labels, feats, feats_cr, temp=0.07, thresh=0.5, block=1024):
    """Supervised pixel contrastive loss for ``--pn`` (losses.py:480-511,
    SupConLossV2_more), per sample: labels (B, N), feats (B, N, C) ->
    (B,)."""
    feats_all = torch.cat([feats, feats_cr], dim=-2).contiguous()
    all_labels = torch.cat([labels, labels], dim=-1)
    pos = (all_labels > thresh).to(feats.dtype)
    unl = (all_labels < thresh).to(feats.dtype)

    logit_pos_sum, partner_logit, total_sum = _row_logit_stats(
        feats_all, pos, temp, block)
    num_pos_total = pos.sum(-1)
    log_tot = torch.log(torch.clamp(total_sum, min=1e-12))

    mean_log_prob_pos = (
        logit_pos_sum - num_pos_total[:, None] * log_tot
    ) / torch.clamp(num_pos_total, min=1.0)[:, None]
    sup = _safe_div((mean_log_prob_pos * pos).sum(-1), num_pos_total)

    neg_rows = partner_logit - log_tot
    negs = _safe_div((neg_rows * unl).sum(-1), unl.sum(-1))
    return -sup - negs


def consistency_loss(out_prob, out_prob_cr):
    """MSE between the two views' heatmaps (losses.py:518-520)."""
    return torch.mean((out_prob - out_prob_cr) ** 2)


def simsiam_loss(p1, z1, p2, z2):
    """Symmetric negative cosine similarity with stop-gradient targets
    (losses.py:523-542; reference trains/tomo_simsiam_trainer.py:28-40):
    loss = -(cos(p1, z2) + cos(p2, z1)) / 2, norms clamped at 1e-12. Also
    returns the collapse monitor: the mean over feature dims of the
    per-dim std (ddof 0, as numpy's) of the normalized z1."""

    def _unit(a):
        return a / torch.linalg.vector_norm(a, dim=-1,
                                            keepdim=True).clamp(min=1e-12)

    def _cos(a, b):
        return (_unit(a) * _unit(b)).sum(dim=-1).mean()

    z1, z2 = z1.detach(), z2.detach()
    loss = -(_cos(p1, z2) + _cos(p2, z1)) / 2
    if is_synced():  # the global batch's std
        z1 = gather_rows(z1)
    return loss, _unit(z1).std(dim=0, correction=0).mean()
