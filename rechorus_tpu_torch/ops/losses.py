"""Training losses (port of rechorus_tpu/ops/losses.py: `masked_softmax`,
`bpr_multi_neg`, the pointwise CTR losses `bce` and `mse`, the listwise
impression losses of :65-195, ContraRec's `infonce`, DirectAU's
`alignment_loss` and `uniformity_loss`, and `margin_rank_loss`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Listwise impression losses
# ---------------------------------------------------------------------------


def impression_loss(prediction: torch.Tensor, target: torch.Tensor, train_max_pos: int,
                    loss_n: str = "BPR") -> torch.Tensor:
    """Dispatch over the four listwise loss families (reference
    src/models/BaseImpressionModel.py:44-128).

    prediction: [B, P+N] scores, columns [0:P) positives, [P:) negatives.
    target: [B, P+N] with +1 valid positive, 0 valid negative, -1 pad.
    """
    if "BPR" in loss_n:
        return _impression_bpr(prediction, target, train_max_pos, loss_n)
    elif loss_n == "listnet":
        return _impression_listnet(prediction, target, train_max_pos)
    elif loss_n == "softmaxCE":
        return _impression_softmax_ce(prediction, target, train_max_pos)
    elif loss_n == "attention_rank":
        return _impression_attention_rank(prediction, target, train_max_pos)
    raise ValueError("Undefined loss function: {}".format(loss_n))


def _valid_mask(target: torch.Tensor) -> torch.Tensor:
    """1.0 for non-pad entries (reference: where(target == -1) + 1)."""
    return (target != -1).float()


def _have_neg(target: torch.Tensor, train_max_pos: int) -> torch.Tensor:
    """Row weight: 1 if the first negative slot is valid (reference
    `test_have_neg = mask[:, train_max_pos_item]`)."""
    return (target[:, train_max_pos] != -1).float()


def _impression_bpr(prediction, target, P, loss_n):
    B, L = prediction.shape
    mask = _valid_mask(target)
    col = torch.arange(L, device=prediction.device)
    pos_mask = (col < P).float()[None, :]
    neg_mask = (col >= P).float()[None, :]
    valid_pair = mask[:, :, None] * mask[:, None, :]
    select_mask = pos_mask[:, :, None] * neg_mask[:, None, :] * valid_pair      # [B, L, L]
    score_diff_mask = (prediction[:, :, None] - prediction[:, None, :]) * select_mask

    neg_softmax = masked_softmax(prediction, (neg_mask * mask) == 1, dim=1)
    pos_valid = (pos_mask * mask) == 1
    if "hard" in loss_n:
        # higher weight for LOWER-score positives (the reference's
        # (pos_pred.min() - pos_pred).softmax: the global min is a shift)
        pos_softmax = masked_softmax(-prediction, pos_valid, dim=1)
    else:
        pos_softmax = masked_softmax(prediction, pos_valid, dim=1)

    if "after" in loss_n:
        loss = ((F.softplus(-score_diff_mask) * neg_softmax[:, None, :]).sum(-1) * pos_softmax).sum(-1)
        return loss.mean()
    elif "before" in loss_n:
        # as the reference: pos_softmax multiplies INSIDE the softplus, and
        # the sum runs over all columns (a zero-weight column adds log 2)
        loss = F.softplus(-(score_diff_mask * neg_softmax[:, None, :]).sum(-1) * pos_softmax).sum(-1)
        return loss.mean()
    elif "simple" in loss_n:
        # the reference returns this un-reduced; mean-reduced, as in the
        # JAX package
        return (F.softplus(-score_diff_mask) * select_mask).sum(-1).sum(-1).mean()
    sig = torch.where(select_mask == 1, torch.sigmoid(score_diff_mask), 0.0)   # 'between'
    agg = ((sig * neg_softmax[:, None, :]).sum(-1) * pos_softmax).sum(-1)
    return -torch.log(agg.clamp_min(1e-12)).mean()


def _row_weight(loss_rows: torch.Tensor, have_neg: torch.Tensor) -> torch.Tensor:
    """The reference's loss * have_neg / have_neg.sum() * B, then .mean():
    the mean over the rows with at least one valid negative."""
    return (loss_rows * have_neg).sum() / have_neg.sum().clamp_min(1.0)


def _impression_listnet(prediction, target, P):
    mask = _valid_mask(target)
    t_soft = masked_softmax(target.float(), mask == 1, dim=1)
    # as the reference: the prediction softmax is NOT masked, so the pads'
    # raw scores stay in the denominator (and pad id 0's row gets a gradient)
    p_soft = torch.where(mask == 1, torch.softmax(prediction, dim=1), 1.0)   # pads -> log 0
    loss_rows = -(t_soft * torch.log(p_soft.clamp_min(1e-12))).sum(dim=1)
    return _row_weight(loss_rows, _have_neg(target, P))


def _impression_softmax_ce(prediction, target, P):
    mask = _valid_mask(target)
    pos_len = (target == 1).sum(dim=1).float().clamp_min(1.0)
    target_pre = masked_softmax(prediction, mask == 1, dim=1)[:, :P]
    target_pre = torch.where(mask[:, :P] == 1, target_pre, 1.0)
    loss_rows = -torch.log(target_pre.clamp_min(1e-12)).sum(dim=1) / pos_len
    return _row_weight(loss_rows, _have_neg(target, P))


def _impression_attention_rank(prediction, target, P):
    mask = _valid_mask(target)
    t_soft = masked_softmax(target.float(), mask == 1, dim=1)
    p_soft = masked_softmax(prediction, mask == 1, dim=1)
    p1 = torch.where(mask == 1, p_soft, 1.0)
    loss_1 = -(t_soft * torch.log(p1.clamp_min(1e-12))).sum(dim=1)
    p2 = torch.where(mask == 1, p_soft, 0.0)
    p2 = torch.where(p2 != 1.0, p2, 0.0)          # singleton rows contribute 0
    loss_2 = -((1 - t_soft) * torch.log((1 - p2).clamp_min(1e-12))).sum(dim=1)
    return _row_weight(loss_1 + loss_2, _have_neg(target, P))


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
