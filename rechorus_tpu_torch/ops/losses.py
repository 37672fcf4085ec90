"""Training losses (port of rechorus_tpu/ops/losses.py:20-46 and :229-251:
`masked_softmax`, `bpr_multi_neg`, DirectAU's `alignment_loss` and
`uniformity_loss`, and `margin_rank_loss`; the other losses come with
their runners and models).
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


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def alignment_loss(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """DirectAU alignment: mean ||u - i||^2 of the L2-normalized rows
    (reference src/models/general/DirectAU.py:54-57)."""
    return ((_l2_normalize(u) - _l2_normalize(i)) ** 2).sum(-1).mean()


def uniformity_loss(x: torch.Tensor) -> torch.Tensor:
    """DirectAU uniformity: log mean exp(-2 * pdist^2) over the pairs i < j
    of the L2-normalized rows (reference DirectAU.py:59-62). The squared
    distances are summed directly, as in the JAX package, so a repeated row
    (distance 0) keeps a finite gradient."""
    x = _l2_normalize(x)
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1, device=x.device)
    return torch.log(torch.exp(-2.0 * sq[iu[0], iu[1]]).mean().clamp_min(1e-12))


def margin_rank_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """TransE-style margin ranking, mean max(0, margin + neg - pos) (CFKG,
    Chorus stage 1; reference src/models/general/CFKG.py:70-76)."""
    return torch.clamp_min(margin + neg_score - pos_score, 0.0).mean()
