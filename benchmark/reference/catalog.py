"""Full-catalog top-k and ranks, scored as one product per block of rows,
and the judgement of served answers against them.

A catalog score is u . table[j] over ids j in [1, n_items); id 0 is the
padding row, and a user's clicked ids are excluded. Every judgement scores
in float64 and gives a gap relative to the row's score scale,
||u|| * max_j ||table[j]|| (no score of the row can exceed it):

- top-k: `topk_gap`, the widest gap by which the j-th served id's score
  lies below the j-th best score, and `score_gap`, the widest gap between
  a served score and its id's score. A served id that is 0, out of range
  or clicked takes the row's lowest score.
- ranks: `rank_gap`, for a rank r the distance from the target's score to
  the score that a count of r - 1 ids above it would need: 0 when r is
  the rank, else the gap to the first id that r counts wrongly. A rank
  outside [1, the row's candidates] takes the row's whole score range.
"""
from __future__ import annotations

import torch


def _masked_scores(u: torch.Tensor, table: torch.Tensor, clicked: torch.Tensor) -> torch.Tensor:
    s = u @ table.T
    s[:, 0] = float("-inf")
    s.scatter_(1, clicked.long(), float("-inf"))    # pads are 0, already masked
    return s


def _scale(u: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return u.norm(dim=1) * table.norm(dim=1).max()


def topk(u, table, clicked, k: int, block: int = 64):
    """(ids [B, k] int64, scores [B, k]) of the top-k unclicked ids, in the
    dtype of the inputs (the control's answers)."""
    ids, vals = [], []
    for lo in range(0, u.shape[0], block):
        v, i = torch.topk(_masked_scores(u[lo: lo + block], table, clicked[lo: lo + block]), k, dim=1)
        ids.append(i)
        vals.append(v)
    return torch.cat(ids), torch.cat(vals)


def judge_topk(u, table, clicked, ids, scores, block: int = 64) -> dict:
    """{"topk_gap", "score_gap"} of served (ids, scores) [B, k]; u, table
    float64, clicked [B, M] (0-padded)."""
    k = ids.shape[1]
    n = table.shape[0]
    topk_gap = score_gap = 0.0
    for lo in range(0, u.shape[0], block):
        ub = u[lo: lo + block]
        s = _masked_scores(ub, table, clicked[lo: lo + block])
        best = torch.topk(s, k, dim=1).values
        low = torch.where(torch.isfinite(s), s, torch.inf).amin(1, keepdim=True)
        sid = ids[lo: lo + block].long()
        ok = (sid >= 1) & (sid < n)
        got = s.gather(1, sid.clamp(0, n - 1))
        got = torch.where(ok & torch.isfinite(got), got, low.expand_as(got))
        scale = _scale(ub, table)[:, None]
        topk_gap = max(topk_gap, float(((best - got) / scale).max()))
        score_gap = max(score_gap, float(((scores[lo: lo + block].to(s.dtype) - got).abs() / scale).max()))
    return {"topk_gap": topk_gap, "score_gap": score_gap}


def ranks(u, table, target, clicked, block: int = 64) -> torch.Tensor:
    """[B] int64 ranks of the targets among the unclicked ids, ties
    counting against the target, in the dtype of the inputs."""
    out = []
    for lo in range(0, u.shape[0], block):
        t = (u[lo: lo + block] * table[target[lo: lo + block].long()]).sum(1)
        s = _masked_scores(u[lo: lo + block], table, clicked[lo: lo + block])
        s.scatter_(1, target[lo: lo + block].long()[:, None], float("-inf"))
        out.append((s >= t[:, None]).sum(1) + 1)
    return torch.cat(out)


def judge_ranks(u, table, target, clicked, got_ranks, block: int = 64) -> dict:
    """{"rank_gap"} of ranks [B] (or [calls, B]: every call's ranks of the
    same rows); u, table float64."""
    got_ranks = got_ranks.reshape(-1, u.shape[0])
    gap = 0.0
    for lo in range(0, u.shape[0], block):
        ub, tb = u[lo: lo + block], target[lo: lo + block].long()
        t = (ub * table[tb]).sum(1, keepdim=True)
        s = _masked_scores(ub, table, clicked[lo: lo + block])
        s.scatter_(1, tb[:, None], float("-inf"))
        finite = torch.isfinite(s)
        n_ok = finite.sum(1, keepdim=True)
        above = (s >= t).sum(1, keepdim=True)                 # the rank minus 1
        desc = torch.sort(torch.where(finite, s, -torch.inf), dim=1, descending=True).values
        whole = desc[:, :1] - torch.where(finite, s, torch.inf).amin(1, keepdim=True)
        scale = _scale(ub, table)[:, None]
        for r in got_ranks[:, lo: lo + block]:
            c = r.long()[:, None] - 1                          # ids counted above the target
            bad = (c < 0) | (c > n_ok)
            over = t - desc.gather(1, (c - 1).clamp(0, desc.shape[1] - 1))
            under = desc.gather(1, c.clamp(0, desc.shape[1] - 1)) - t
            g = torch.where(c > above, over, torch.where(c < above, under, torch.zeros_like(t)))
            g = torch.where(bad, whole, g)
            gap = max(gap, float((g / scale).max()))
    return {"rank_gap": gap}
