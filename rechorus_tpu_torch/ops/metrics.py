"""Evaluation metric kernels (port of rechorus_tpu/ops/metrics.py:31-150,
a copy of its numpy listwise metrics :151-250, and :251-280).

Ranks count ties AGAINST the ground truth: gt_rank = (predictions >=
predictions[:, 0]).sum(-1), reference src/helpers/BaseRunner.py:63. The
CTR metrics (AUC, log loss, accuracy, F1; reference
src/helpers/CTRRunner.py:22-43) are numpy on the host, over the
predictions and labels the runner collected.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from rechorus_tpu_torch.ops.topk import approx_max_k


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


def auc_score(labels: np.ndarray, predictions: np.ndarray) -> float:
    """Tie-aware ROC AUC (Mann-Whitney with average ranks).

    Matches sklearn.metrics.roc_auc_score, which the reference calls
    (src/helpers/CTRRunner.py:35), without the sklearn dependency at
    runtime (tests assert parity against sklearn).
    """
    labels = np.asarray(labels).astype(np.int64)
    predictions = np.asarray(predictions, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined with a single class")
    order = np.argsort(predictions, kind="mergesort")
    sorted_pred = predictions[order]
    # average ranks over tie groups (1-indexed)
    ranks = np.empty(len(predictions), dtype=np.float64)
    base = np.arange(1, len(predictions) + 1, dtype=np.float64)
    # vectorized tie-group averaging
    _, inverse, counts = np.unique(sorted_pred, return_inverse=True, return_counts=True)
    group_sums = np.bincount(inverse, weights=base)
    avg_rank_per_group = group_sums / counts
    ranks[order] = avg_rank_per_group[inverse]
    pos_rank_sum = ranks[labels == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def log_loss(labels: np.ndarray, predictions: np.ndarray, eps: float = 1e-7) -> float:
    """BCE with clipping, parity with reference CTRRunner.py:38-40."""
    p = np.clip(np.asarray(predictions, dtype=np.float64), eps, 1 - eps)
    y = np.asarray(labels, dtype=np.float64)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def accuracy(labels: np.ndarray, predictions: np.ndarray) -> float:
    return float(((np.asarray(predictions) > 0.5).astype(int) == np.asarray(labels)).mean())


def f1_score(labels: np.ndarray, predictions: np.ndarray) -> float:
    pred = (np.asarray(predictions) > 0.5).astype(int)
    y = np.asarray(labels).astype(int)
    tp = int(((pred == 1) & (y == 1)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def evaluate_ctr(predictions: np.ndarray, labels: np.ndarray, metrics: List[str]) -> Dict[str, float]:
    """CTR metric dispatch, parity with reference CTRRunner.py:22-43."""
    evaluations = dict()
    for metric in metrics:
        if metric == "ACC":
            evaluations[metric] = accuracy(labels, predictions)
        elif metric == "AUC":
            evaluations[metric] = auc_score(labels, predictions)
        elif metric == "F1_SCORE":
            evaluations[metric] = f1_score(labels, predictions)
        elif metric == "LOG_LOSS":
            evaluations[metric] = log_loss(labels, predictions)
        else:
            raise ValueError("Undefined evaluation metric: {}.".format(metric))
    return evaluations


# -------------------- masked listwise metrics (impressions) ----------------
# numpy on the host, over the [B, P + N] score rows ImpressionRunner
# collects; copied from the JAX package (reference ImpressionRunner.py:18-133)


def hr_at_k(labels: np.ndarray, valid_num: np.ndarray, k: int) -> np.ndarray:
    """Listwise hit rate: 1 if any positive is ranked before k.
    labels: [B, L] binary, already sorted by predicted rank; valid_num: [B]
    valid (non-pad) entries per row."""
    indices = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * indices
    num_hits = np.sum(labels[:, :k], axis=1)
    positive_num = np.sum(labels, axis=1)
    positive_num[positive_num == 0] = 1
    positive_num[positive_num > k] = k
    hit_rate = num_hits / positive_num
    hit_rate[hit_rate > 0] = 1
    return hit_rate


def dcg_at_k(labels: np.ndarray, valid_num: np.ndarray, k: int) -> np.ndarray:
    indices = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * indices
    labels = labels[:, :k]
    return np.sum(labels / np.log2(np.arange(2, labels.shape[1] + 2)), axis=1)


def ndcg_at_k(labels: np.ndarray, valid_num: np.ndarray, k: int) -> np.ndarray:
    """The ideal DCG by a sort (reference ImpressionRunner.py:38-51)."""
    indices = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * indices
    dcg = dcg_at_k(labels, valid_num, k)
    sorted_labels = np.sort(labels, axis=1)[:, ::-1]
    ideal_dcg = dcg_at_k(sorted_labels, valid_num, k)
    ideal_dcg[ideal_dcg == 0] = 1
    return dcg / ideal_dcg


def ap_at_k(labels: np.ndarray, valid_num: np.ndarray, k: int) -> np.ndarray:
    """Reference ImpressionRunner.py:53-66."""
    indices = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * indices
    num_positive_predictions = np.cumsum(labels, axis=1)
    num_positive_predictions[:, k:] = 0
    precision = num_positive_predictions / np.arange(1, labels.shape[1] + 1)
    positive_num = np.sum(labels, axis=1)
    positive_num[positive_num == 0] = 1
    positive_num[positive_num > k] = k
    return np.sum(precision * labels, axis=1) / positive_num


def evaluate_impression(predictions: np.ndarray, topk: List[int], metrics: List[str],
                        pos_num: np.ndarray, neg_num: np.ndarray,
                        pos_num_max: int) -> Dict[str, float]:
    """Listwise evaluation over padded [pos_pad | neg_pad] score rows,
    predictions [B, pos_num_max + neg_num_max] with the pads at -inf. The
    scores are cast to float64 and the positives lowered by 1e-6, so that a
    tie ranks a positive last; the mergesort keeps the order of equal keys
    (reference ImpressionRunner.py:73-133)."""
    evaluations = dict()
    predictions = np.asarray(predictions, dtype=np.float64).copy()
    pos_num = np.asarray(pos_num)
    neg_num = np.asarray(neg_num)
    B, L = predictions.shape
    neg_num_max = L - pos_num_max

    eps = 1e-6
    predictions[:, :pos_num_max] -= eps  # positives lose ties

    sort_idx = (-predictions).argsort(axis=1, kind="mergesort")

    pos_num_cliped = np.minimum(pos_num, pos_num_max)
    neg_num_cliped = np.minimum(neg_num, neg_num_max)
    whole_len = pos_num_cliped + neg_num_cliped

    labels = (np.arange(pos_num_max) < pos_num_cliped[:, None]).astype(int)
    labels = np.concatenate((labels, np.zeros((B, L - pos_num_max), dtype=int)), axis=1)
    labels = np.take_along_axis(labels, sort_idx, axis=1)

    for metric in metrics:
        for k in topk:
            key = "{}@{}".format(metric, k)
            if metric == "NDCG":
                evaluations[key] = ndcg_at_k(labels, whole_len, k).mean()
            elif metric == "MAP":
                evaluations[key] = ap_at_k(labels, whole_len, k).mean()
            elif metric == "HR":
                evaluations[key] = hr_at_k(labels, whole_len, k).mean()
            else:
                raise ValueError("Undefined evaluation metric: {}.".format(metric))
    return evaluations


def masked_topk(pred: torch.Tensor, clicked_rows: torch.Tensor, k: int,
                n_valid: int | None = None, approx: bool = False,
                recall_target: float = 0.98):
    """Gather-only top-k with exclusions: column 0 (pad item), columns >=
    n_valid (dead padded table rows) and the ids in clicked_rows [B, M]
    (0-padded). Two-stage: the top k+M candidates (a clicked item can
    displace at most M winners), knock out clicked among them by a
    [B, k+M, M] compare, re-top-k. `approx=True` takes the k+M candidates
    with `topk.approx_max_k` at `recall_target` (the approx lane).

    pred [B, N] -> (values [B, k'], column ids [B, k'] int32), k' = min(k, N).
    """
    B, N = pred.shape
    cols = torch.arange(N, device=pred.device)
    ok = cols > 0
    if n_valid is not None and n_valid < N:
        ok &= cols < n_valid
    pred = pred.masked_fill(~ok[None, :], float("-inf"))
    k_wide = min(N, k + clicked_rows.shape[1])
    if approx:
        v, i = approx_max_k(pred, k_wide, recall_target)
    else:
        v, i = torch.topk(pred, k_wide, dim=1)
    hit = (i[:, :, None] == clicked_rows[:, None, :].long()).any(-1)
    v = v.masked_fill(hit, float("-inf"))
    v2, sel = torch.topk(v, min(k, k_wide), dim=1)
    return v2, i.gather(1, sel).to(torch.int32)
