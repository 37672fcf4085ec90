"""ComiRec (Cen et al., KDD'20, arXiv:2005.09347), its self-attentive
variant, the equations of ReChorus 2.0 src/models/sequential/ComiRec.py,
frozen here:

    position p_l = length - l for the l-th of `length` left-aligned
        history ids h_l, 0 on padding
    x_l = i_emb[h_l] + p_emb[p_l]                      (add_pos)
    A   = softmax over l of W2 tanh(W1 x_l + b1) + b2,  [K, L], masked to
          the valid history (a row with no history attends to nothing)
    z_k = sum_l A_kl i_emb[h_l]                        the K interests
    score(i) = max_k z_k . i_emb[i]                    (evaluation)

Parameter names are the leaves of ReChorus's module (`i_embeddings`,
`p_embeddings`, `W1`, `W2`: weights [out, in]). Beside the equations: the
multi-interest ranks and their judgement (`ranks`, `judge_ranks`: the
copies of `catalog.ranks` and `catalog.judge_ranks` with the max over k),
and the operations and bytes of the multi-interest rank kernel
(`interest_ge`)."""
from __future__ import annotations

import math

import torch

from . import bpr

# trains and ranks rows with position > 0, each with its history
SEQUENTIAL = True
F32 = 4


def param_shapes(config: dict) -> dict:
    d, a, K = config["emb_size"], config["attn_size"], config["K"]
    shapes = {"i_embeddings.weight": (config["n_items"], d)}
    if config["add_pos"]:
        shapes["p_embeddings.weight"] = (config["history_max"] + 1, d)
    shapes.update({"W1.weight": (a, d), "W1.bias": (a,), "W2.weight": (K, a), "W2.bias": (K,)})
    return shapes


def param_count(config: dict) -> int:
    return sum(math.prod(s) for s in param_shapes(config).values())


def forward_flops(config: dict, rows: int, candidates: int) -> float:
    """Multiply-adds x 2 over `rows` padded histories of history_max
    positions: W1 and W2, the K weighted sums of the interests, and the
    scores of `candidates` items against each of the K interests."""
    d, a, K, L = config["emb_size"], config["attn_size"], config["K"], config["history_max"]
    return rows * (2.0 * L * d * a + 2.0 * L * a * K + 2.0 * K * L * d + 2.0 * K * candidates * d)


def interest_ge(B: int, K: int, N: int, D: int) -> tuple[float, float]:
    """(operations, bytes) of one launch of the multi-interest rank count
    (`rtt_interest_ge_kernel`): 2 B K N D operations; reads the table, the
    B K interest rows and the [B] target scores and target ids, writes [B]
    int32 counts."""
    return 2.0 * B * K * N * D, F32 * (N * D + B * K * D + 2 * B) + F32 * B


def item_table(config: dict, w: dict):
    return w["i_embeddings.weight"]


def user_vectors(config: dict, w: dict, rows: dict):
    """[B, K, D] interests of rows["history"] [B, L] (left-aligned,
    0-padded) with rows["length"] [B]."""
    history, length = rows["history"], rows["length"]
    L = history.shape[1]
    valid = history > 0
    h = w["i_embeddings.weight"][history]
    x = h
    if config["add_pos"]:
        pos = (length[:, None] - torch.arange(L, device=history.device)[None, :]) * valid
        x = h + w["p_embeddings.weight"][pos]
    hidden = torch.tanh(x @ w["W1.weight"].T + w["W1.bias"])
    logits = (hidden @ w["W2.weight"].T + w["W2.bias"]).transpose(1, 2)      # [B, K, L]
    attn = torch.softmax(logits.masked_fill(~valid[:, None, :], float("-inf")), -1)
    return torch.nan_to_num(attn) @ h


def prediction(config: dict, w: dict, rows: dict):
    """[B, C] evaluation scores of rows["items"]: the max over the
    interests."""
    z = user_vectors(config, w, rows)
    return (w["i_embeddings.weight"][rows["items"]] @ z.transpose(1, 2)).amax(-1)


def loss(config: dict, w: dict, rows: dict):
    return bpr.loss(prediction(config, w, rows))


# ------------------------------------------------ multi-interest catalog --
def _scores(u, table):
    B, K, D = u.shape
    return (u.reshape(B * K, D) @ table.T).view(B, K, -1).amax(1)


def _masked_scores(u, table, clicked):
    s = _scores(u, table)
    s[:, 0] = float("-inf")
    s.scatter_(1, clicked.long(), float("-inf"))    # pads are 0, already masked
    return s


def _target_scores(u, table, target):
    return (u * table[target.long()][:, None, :]).sum(-1).amax(1)


def _scale(u, table):
    """max_k ||u_k|| * max_j ||table[j]||: no score of the row exceeds it."""
    return u.norm(dim=2).amax(1) * table.norm(dim=1).max()


def ranks(u, table, target, clicked, block: int = 32) -> torch.Tensor:
    """[B] int64 ranks of the targets among the unclicked ids by the
    max-over-interests score, ties counting against the target, in the
    dtype of the inputs (u [B, K, D])."""
    out = []
    for lo in range(0, u.shape[0], block):
        ub, tb = u[lo: lo + block], target[lo: lo + block]
        t = _target_scores(ub, table, tb)
        s = _masked_scores(ub, table, clicked[lo: lo + block])
        s.scatter_(1, tb.long()[:, None], float("-inf"))
        out.append((s >= t[:, None]).sum(1) + 1)
    return torch.cat(out)


def judge_ranks(u, table, target, clicked, got_ranks, block: int = 32) -> dict:
    """{"rank_gap"} of ranks [B] (or [calls, B]: every call's ranks of the
    same rows), as `catalog.judge_ranks` over the max-over-interests
    scores; u [B, K, D] and table float64."""
    got_ranks = got_ranks.reshape(-1, u.shape[0])
    gap = 0.0
    for lo in range(0, u.shape[0], block):
        ub, tb = u[lo: lo + block], target[lo: lo + block].long()
        t = _target_scores(ub, table, tb)[:, None]
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
