"""TiSASRec -- time-interval-aware self-attention (port of
rechorus_tpu/models/sequential/tisasrec.py).

Reference behavior: src/models/sequential/TiSASRec.py (Li et al.,
WSDM'20): SASRec plus pairwise time-interval key/value embeddings.
Intervals = |t_i - t_j| / the user's minimum interval, truncated and
clipped to --time_max; attention scores add q . inter_k and outputs add
the attention-weighted inter_v (TimeIntervalMultiHeadAttention,
TiSASRec.py:118-199).
CMD example:
  python -m rechorus_tpu_torch.main --model_name TiSASRec --emb_size 64 --num_layers 1 \
      --num_heads 1 --lr 1e-4 --l2 1e-6 --history_max 20 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import math
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import Dense, LayerNorm, dropout, embed
from rechorus_tpu_torch.registry import register_model


class TimeIntervalTransformerLayer(nn.Module):
    """Post-LN block whose attention takes absolute-position and pairwise
    interval K/V embeddings (reference TiSASRec.py:118-199)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.n_heads, self.dropout = d_model, n_heads, dropout
        self.q, self.k, self.v = (Dense(d_model, d_model) for _ in range(3))
        self.ln1 = LayerNorm(d_model)
        self.ff1 = Dense(d_model, d_ff)
        self.ff2 = Dense(d_ff, d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, seq, pos_k, pos_v, inter_k, inter_v, mask, training: bool = False, gen=None):
        B, L, _ = seq.shape
        h, d_k = self.n_heads, self.d_model // self.n_heads
        q = self.q(seq).reshape(B, L, h, d_k).transpose(1, 2)
        k = (self.k(seq) + pos_k).reshape(B, L, h, d_k).transpose(1, 2)
        v = (self.v(seq) + pos_v).reshape(B, L, h, d_k).transpose(1, 2)
        ik = inter_k.reshape(B, L, L, h, d_k).permute(0, 3, 1, 2, 4)    # [B, h, L, L, d_k]
        iv = inter_v.reshape(B, L, L, h, d_k).permute(0, 3, 1, 2, 4)
        scores = q @ k.transpose(-1, -2) + torch.einsum("bhqd,bhqkd->bhqk", q, ik)
        scores = (scores / math.sqrt(d_k)).masked_fill(~mask, float("-inf"))
        attn = torch.nan_to_num(torch.softmax(scores, dim=-1))
        out = attn @ v + torch.einsum("bhqk,bhqkd->bhqd", attn, iv)
        context = out.transpose(1, 2).reshape(B, L, self.d_model)
        context = self.ln1(dropout(context, self.dropout, training, gen) + seq)
        ff = self.ff2(torch.relu(self.ff1(context)))
        return self.ln2(dropout(ff, self.dropout, training, gen) + context)


@register_model("TiSASRec")
class TiSASRec(SequentialModel):
    batcher: ClassVar[str] = "tisas"
    extra_log_args: ClassVar[list] = ["emb_size", "num_layers", "num_heads", "time_max"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, num_layers: int = 1, num_heads: int = 4,
                 time_max: int = 512, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.num_layers, self.num_heads, self.time_max = \
            emb_size, num_layers, num_heads, time_max
        self.i_embeddings = embed(self.item_num, emb_size)
        self.p_k_embeddings = embed(self.history_max + 1, emb_size)
        self.p_v_embeddings = embed(self.history_max + 1, emb_size)
        self.t_k_embeddings = embed(time_max + 1, emb_size)
        self.t_v_embeddings = embed(time_max + 1, emb_size)
        for b in range(num_layers):
            self.add_module(f"block_{b}", TimeIntervalTransformerLayer(
                emb_size, emb_size, num_heads, dropout=self.dropout))

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--num_layers", type=int, default=1, help="Number of self-attention layers.")
        parser.add_argument("--num_heads", type=int, default=4, help="Number of attention heads.")
        parser.add_argument("--time_max", type=int, default=512, help="Max time intervals.")
        return SequentialModel.parse_model_args(parser)

    def intervals(self, t_history, user_min_t):
        """[B, L, L] interval buckets in [0, time_max]. As the JAX package
        computes them (without x64): times and minimum gaps as int32 (a
        user with no positive gap, 0xFFFFFFFF, wraps to -1 and clamps to
        1), the gap divided as float32 and truncated."""
        t = t_history.to(torch.int32)
        gap = (t[:, :, None] - t[:, None, :]).abs()
        min_t = user_min_t.to(torch.int32).clamp_min(1)
        ratio = gap.to(torch.float32) / min_t.to(torch.float32)[:, None, None]
        return ratio.to(torch.int32).clamp(0, self.time_max).long()

    def encode(self, feed, training: bool, gen):
        """[B, D] state at position lengths - 1 of the history stack."""
        history, lengths = feed["history_items"], feed["lengths"]
        B, L = history.shape
        valid = history > 0
        his = self.i_embeddings(history)
        position = (lengths[:, None] - torch.arange(L, device=history.device)[None, :]) * valid
        pos_k, pos_v = self.p_k_embeddings(position), self.p_v_embeddings(position)
        interval = self.intervals(feed["history_times"], feed["user_min_intervals"])
        inter_k, inter_v = self.t_k_embeddings(interval), self.t_v_embeddings(interval)
        causal = torch.ones((L, L), dtype=torch.bool, device=history.device).tril()
        for b in range(self.num_layers):
            his = getattr(self, f"block_{b}")(his, pos_k, pos_v, inter_k, inter_v, causal,
                                              training=training, gen=gen)
        his = his * valid[:, :, None]
        last = (lengths - 1).clamp(min=0)
        return his.gather(1, last[:, None, None].expand(B, 1, his.shape[2]))[:, 0]

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        his_vector = self.encode(feed, training, gen)
        if catalog:
            return {"u_v": his_vector}
        i_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}
