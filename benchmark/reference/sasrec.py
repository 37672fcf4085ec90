"""SASRec (Kang & McAuley, ICDM'18), the equations of ReChorus 2.0
src/models/sequential/SASRec.py with src/utils/layers.py, frozen here:

    x = i_emb[history] + p_emb[position],  position = (length - l) for the
        l-th of `length` left-aligned history ids, 0 on padding
    per layer (post-LN, one or more heads, causal mask, no dropout):
        a   = softmax(q k^T / sqrt(d_head) masked to l' <= l) v,
              q, k, v = x W_q^T + b_q, x W_k^T + b_k, x W_v^T + b_v
        x   = LN1(a + x)
        x   = LN2(W_2^T relu(x W_1^T + b_1) + b_2 + x)
    h = x at position length - 1;  score(h, i) = h . i_emb[i]

LayerNorm eps 1e-5. Parameter names are the state_dict keys of ReChorus's
module (`transformer_<k>.mha.{k,q,v}`, `ln1`, `ff1`, `ff2`, `ln2`)."""
from __future__ import annotations

import math

import torch

from . import bpr

# trains and ranks rows with position > 0, each with its history
SEQUENTIAL = True


def param_shapes(config: dict) -> dict:
    d, n_items, h = config["emb_size"], config["n_items"], config["history_max"]
    shapes = {"i_embeddings.weight": (n_items, d), "p_embeddings.weight": (h + 1, d)}
    for k in range(config["num_layers"]):
        p = f"transformer_{k}."
        for proj in ("mha.k", "mha.q", "mha.v"):
            shapes[p + proj + ".weight"] = (d, d)
            shapes[p + proj + ".bias"] = (d,)
        shapes[p + "ln1.weight"], shapes[p + "ln1.bias"] = (d,), (d,)
        shapes[p + "ff1.weight"], shapes[p + "ff1.bias"] = (d, d), (d,)
        shapes[p + "ff2.weight"], shapes[p + "ff2.bias"] = (d, d), (d,)
        shapes[p + "ln2.weight"], shapes[p + "ln2.bias"] = (d,), (d,)
    return shapes


def param_count(config: dict) -> int:
    return sum(math.prod(s) for s in param_shapes(config).values())


def forward_flops(config: dict, rows: int, candidates: int) -> float:
    """Multiply-adds x 2 of the encoder over `rows` padded histories of
    history_max positions (q, k, v and the two feed-forward products; the
    attention's two products), and of scoring `candidates` items a row."""
    d, L = config["emb_size"], config["history_max"]
    layer = 2.0 * L * d * d * 5 + 2.0 * 2 * L * L * d
    return rows * (config["num_layers"] * layer + 2.0 * candidates * d)


def item_table(config: dict, w: dict):
    return w["i_embeddings.weight"]


def _linear(x, w, p):
    return x @ w[p + ".weight"].T + w[p + ".bias"]


def _layer_norm(x, w, p):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w[p + ".weight"], w[p + ".bias"], 1e-5)


def user_vectors(config: dict, w: dict, rows: dict):
    """[B, D] encoder states of rows["history"] [B, L] (left-aligned,
    0-padded) with rows["length"] [B]."""
    history, length = rows["history"], rows["length"]
    B, L = history.shape
    valid = history > 0
    pos = (length[:, None] - torch.arange(L, device=history.device)[None, :]) * valid
    x = w["i_embeddings.weight"][history] + w["p_embeddings.weight"][pos]
    causal = torch.ones(L, L, dtype=torch.bool, device=history.device).tril()
    heads, d = config["num_heads"], config["emb_size"]
    dh = d // heads

    def split(t):
        return t.reshape(B, L, heads, dh).transpose(1, 2)

    for k in range(config["num_layers"]):
        p = f"transformer_{k}."
        q, kk, v = (split(_linear(x, w, p + n)) for n in ("mha.q", "mha.k", "mha.v"))
        att = (q @ kk.transpose(-1, -2) / math.sqrt(dh)).masked_fill(~causal, float("-inf"))
        a = (torch.nan_to_num(torch.softmax(att, -1)) @ v).transpose(1, 2).reshape(B, L, d)
        x = _layer_norm(a + x, w, p + "ln1")
        ff = _linear(torch.relu(_linear(x, w, p + "ff1")), w, p + "ff2")
        x = _layer_norm(ff + x, w, p + "ln2")
    last = (length - 1).clamp(min=0)
    return x[torch.arange(B, device=x.device), last] * (length > 0)[:, None]


def prediction(config: dict, w: dict, rows: dict):
    h = user_vectors(config, w, rows)
    return (h[:, None, :] * w["i_embeddings.weight"][rows["items"]]).sum(-1)


def loss(config: dict, w: dict, rows: dict):
    return bpr.loss(prediction(config, w, rows))
