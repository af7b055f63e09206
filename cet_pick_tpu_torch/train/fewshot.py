"""The labeled-set supervised contrastive loss of the few-shot trainer — the
one function of ``cet_pick_tpu/train/fewshot.py`` that supervised ``tomo``
training needs (``partial_sup_loss``, fewshot.py:72-95; reference
cet_pick/models/loss.py:907-935). The rest of the few-shot trainer is not
ported yet.

JAX pins this similarity product to ``Precision.HIGHEST`` (fewshot.py:49);
the port's counterpart is a float32 matmul with TF32 off, which the train
entry sets under ``--dtype float32`` (``infer/detector.
set_float32_precision``) and which is PyTorch's default for matmuls.
"""

from __future__ import annotations

import torch


def partial_sup_loss(embeddings, gt_labels, temp=0.07):
    """Supervised contrastive loss over labeled rows.

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
