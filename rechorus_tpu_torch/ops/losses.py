"""Training losses (port of rechorus_tpu/ops/losses.py:20-59 and :196-251:
`masked_softmax`, `bpr_multi_neg`, the pointwise CTR losses `bce` and
`mse`, ContraRec's `infonce`, DirectAU's `alignment_loss` and
`uniformity_loss`, and `margin_rank_loss`; the listwise impression losses
come with their runner).
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


def bce(predictions: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on probabilities (post-sigmoid), clipped to
    [eps, 1 - eps] (reference BaseModel.py:262-274)."""
    p = predictions.clamp(eps, 1 - eps)
    y = labels.to(p.dtype)
    return -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean()


def mse(predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ((predictions - labels.to(predictions.dtype)) ** 2).mean()


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows of unit L2 norm, the norm floored at 1e-12 as in the JAX package."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def infonce(features: torch.Tensor, temperature: float = 1.0,
            same_target_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Context-context contrastive loss over the views of each row
    (ContraRec's CCC; reference src/models/sequential/ContraRec.py:142-195).
    features [B, V, D]; same_target_mask [B, B] bool, True where two rows
    share their target (those pairs count as positives, not negatives);
    None = each row is its own only positive.

    The views are concatenated VIEW-MAJOR ([view 0 of every row; view 1 of
    every row; ...], the reference's cat(unbind(dim=1))), which is what the
    mask's V x V tiling assumes; the row max is subtracted without
    gradient."""
    B, V, _ = features.shape
    feats = l2_normalize(features)
    flat = feats.transpose(0, 1).reshape(V * B, -1)
    sim = flat @ flat.T / temperature                                  # [VB, VB]
    if same_target_mask is None:
        same_target_mask = torch.eye(B, dtype=torch.bool, device=features.device)
    logits_mask = ~torch.eye(B * V, dtype=torch.bool, device=features.device)   # no self-contrast
    mask = same_target_mask.repeat(V, V) & logits_mask
    sim = sim - sim.amax(dim=1, keepdim=True).detach()
    exp_sim = torch.where(logits_mask, torch.exp(sim), 0.0)
    log_prob = sim - torch.log(exp_sim.sum(dim=1, keepdim=True).clamp_min(1e-12))
    pos_cnt = mask.sum(dim=1).clamp_min(1)
    return -(torch.where(mask, log_prob, 0.0).sum(dim=1) / pos_cnt).mean()


def alignment_loss(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """DirectAU alignment: mean ||u - i||^2 of the L2-normalized rows
    (reference src/models/general/DirectAU.py:54-57)."""
    return ((l2_normalize(u) - l2_normalize(i)) ** 2).sum(-1).mean()


def uniformity_loss(x: torch.Tensor) -> torch.Tensor:
    """DirectAU uniformity: log mean exp(-2 * pdist^2) over the pairs i < j
    of the L2-normalized rows (reference DirectAU.py:59-62). The squared
    distances are summed directly, as in the JAX package, so a repeated row
    (distance 0) keeps a finite gradient."""
    x = l2_normalize(x)
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1, device=x.device)
    return torch.log(torch.exp(-2.0 * sq[iu[0], iu[1]]).mean().clamp_min(1e-12))


def margin_rank_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """TransE-style margin ranking, mean max(0, margin + neg - pos) (CFKG,
    Chorus stage 1; reference src/models/general/CFKG.py:70-76)."""
    return torch.clamp_min(margin + neg_score - pos_score, 0.0).mean()
