"""Evaluation metric kernels (port of rechorus_tpu/ops/metrics.py:31-83,
251-280, exact lane).

Ranks count ties AGAINST the ground truth: gt_rank = (predictions >=
predictions[:, 0]).sum(-1), reference src/helpers/BaseRunner.py:63.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def gt_rank(predictions: torch.Tensor, valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rank of the ground-truth item (column 0), ties counted against it.

    predictions [B, C] with the positive in column 0; valid_mask optional
    [B, C] bool (invalid candidates never outrank). Returns int32 [B]."""
    ge = predictions >= predictions[:, :1]
    if valid_mask is not None:
        ge &= valid_mask
    return ge.sum(-1).to(torch.int32)


def evaluate_topk_from_ranks(gt_ranks: np.ndarray, topk: List[int], metrics: List[str]) -> Dict[str, float]:
    """HR/NDCG@k means from ground-truth ranks (reference
    src/helpers/BaseRunner.py:51-78)."""
    evaluations = dict()
    gt_ranks = np.asarray(gt_ranks)
    for k in topk:
        hit = gt_ranks <= k
        for metric in metrics:
            key = "{}@{}".format(metric, k)
            if metric == "HR":
                evaluations[key] = hit.mean()
            elif metric == "NDCG":
                evaluations[key] = (hit / np.log2(gt_ranks + 1)).mean()
            else:
                raise ValueError("Undefined evaluation metric: {}.".format(metric))
    return evaluations


def masked_topk(pred: torch.Tensor, clicked_rows: torch.Tensor, k: int,
                n_valid: int | None = None):
    """Gather-only top-k with exclusions: column 0 (pad item), columns >=
    n_valid (dead padded table rows) and the ids in clicked_rows [B, M]
    (0-padded). Two-stage: the top k+M candidates (a clicked item can
    displace at most M winners), knock out clicked among them by a
    [B, k+M, M] compare, re-top-k.

    pred [B, N] -> (values [B, k'], column ids [B, k'] int32), k' = min(k, N).
    """
    B, N = pred.shape
    cols = torch.arange(N, device=pred.device)
    ok = cols > 0
    if n_valid is not None and n_valid < N:
        ok &= cols < n_valid
    pred = pred.masked_fill(~ok[None, :], float("-inf"))
    k_wide = min(N, k + clicked_rows.shape[1])
    v, i = torch.topk(pred, k_wide, dim=1)
    hit = (i[:, :, None] == clicked_rows[:, None, :].long()).any(-1)
    v = v.masked_fill(hit, float("-inf"))
    v2, sel = torch.topk(v, min(k, k_wide), dim=1)
    return v2, i.gather(1, sel).to(torch.int32)
