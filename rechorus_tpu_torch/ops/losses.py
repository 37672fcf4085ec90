"""Training losses (port of rechorus_tpu/ops/losses.py:32-46,
`bpr_multi_neg` only; the other losses come with their runners).
"""
from __future__ import annotations

import torch


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
