"""Training losses (port of rechorus_tpu/ops/losses.py:20-46:
`masked_softmax` and `bpr_multi_neg`; the other losses come with their
runners and models).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite stand-in for -inf: keeps softmax grads NaN-free


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` restricted to mask == True; all-masked rows -> 0.
    The max is taken without gradient, as the JAX version's stop_gradient."""
    logits = torch.where(mask, logits, NEG_INF)
    logits = logits - logits.amax(dim=dim, keepdim=True).detach()
    unnorm = torch.where(mask, torch.exp(logits), 0.0)
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / denom.clamp(min=1e-12)


def bpr_multi_neg(predictions: torch.Tensor) -> torch.Tensor:
    """BPR ranking loss over 1 positive (col 0) + N softmax-weighted negatives.

    loss = -log( clip( sum_j sigmoid(pos - neg_j) * softmax(neg)_j ) )
    Parity: reference src/models/BaseModel.py:175-189. The softmax is per
    row; the clip to [1e-8, 1 - 1e-8] keeps the log finite.
    """
    pos_pred, neg_pred = predictions[:, 0], predictions[:, 1:]
    neg_softmax = torch.softmax(neg_pred, dim=1)
    agg = (torch.sigmoid(pos_pred[:, None] - neg_pred) * neg_softmax).sum(dim=1)
    return -torch.log(agg.clamp(1e-8, 1 - 1e-8)).mean()
