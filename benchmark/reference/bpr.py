"""ReChorus's BPR loss over one positive and softmax-weighted negatives
(src/models/BaseModel.py:175-189):

    loss = -mean log clip( sum_j sigmoid(pos - neg_j) softmax(neg)_j, 1e-8, 1 - 1e-8 )
"""
from __future__ import annotations

import torch


def loss(prediction: torch.Tensor) -> torch.Tensor:
    """prediction [B, 1 + n_neg], the positive in column 0."""
    pos, neg = prediction[:, :1], prediction[:, 1:]
    agg = (torch.sigmoid(pos - neg) * torch.softmax(neg, dim=1)).sum(1)
    return -torch.log(agg.clamp(1e-8, 1 - 1e-8)).mean()
