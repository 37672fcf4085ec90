"""SetRank -- permutation-invariant set attention re-ranking (port of
rechorus_tpu/models/reranker/setrank.py).

Reference behavior: src/models/reranker/SetRank.py (Pang et al.,
SIGIR'20): PRM's [item emb | u_v | i_v] input, the position embedding
added AFTER rFF0, then MSAB (multihead set attention) or IMSAB (induced,
m = 20 inducing points) blocks.
"""
from __future__ import annotations

import torch
from torch import nn

from rechorus_tpu_torch.models.base import RerankModel, RerankSeqModel
from rechorus_tpu_torch.ops.layers import Dense, LayerNorm, MultiHeadAttention, dropout, embed
from rechorus_tpu_torch.registry import register_model

N_INDUCING = 20


class MAB(nn.Module):
    """Multihead attention block: norm1(Q + attn(Q, K, V)), then
    norm2(x + FF(x)) (reference SetRank.py:29-56)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int = 128, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiHeadAttention(d_model, n_heads, out_proj=True)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, d_ff)
        self.linear2 = Dense(d_ff, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, Q, K, V, key_padding_mask=None, training: bool = False, gen=None):
        mask = None if key_padding_mask is None else (~key_padding_mask)[:, None, None, :]
        x = self.norm1(Q + dropout(self.attn(Q, K, V, mask=mask), self.dropout, training, gen))
        ff = self.linear2(dropout(torch.relu(self.linear1(x)), self.dropout, training, gen))
        return self.norm2(x + dropout(ff, self.dropout, training, gen))


class SetRankBase:
    @staticmethod
    def parse_model_args_setrank(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of item embedding vectors.")
        parser.add_argument("--n_blocks", type=int, default=4, help="num of blocks of MSAB/IMSAB")
        parser.add_argument("--num_heads", type=int, default=4, help="Number of attention heads.")
        parser.add_argument("--num_hidden_unit", type=int, default=64, help="Hidden units.")
        parser.add_argument("--setrank_type", type=str, default="IMSAB", help="MSAB or IMSAB")
        return parser

    def init_setrank(self, emb_size: int, n_blocks: int, num_heads: int, num_hidden_unit: int,
                     setrank_type: str) -> None:
        self.emb_size, self.n_blocks, self.num_heads = emb_size, n_blocks, num_heads
        self.num_hidden_unit, self.setrank_type = num_hidden_unit, setrank_type
        h = num_hidden_unit
        self.i_embeddings = embed(self.item_num, emb_size)
        self.rFF0 = Dense(emb_size + 2 * self.ranker_emb_size, h)
        # sized by the larger of the train / test caps (see prm.py)
        self.ordinal_position_embedding = embed(
            max(self.train_max_pos_item + self.train_max_neg_item,
                self.test_max_pos_item + self.test_max_neg_item), h)
        for k in range(n_blocks):
            if setrank_type == "MSAB":
                self.add_module(f"msab_{k}", MAB(h, num_heads, dropout=self.dropout))
            else:
                setattr(self, f"inducing_{k}", nn.Parameter(torch.empty(N_INDUCING, h)))
                self.add_module(f"imsab_{k}_1", MAB(h, num_heads, dropout=self.dropout))
                self.add_module(f"imsab_{k}_2", MAB(h, num_heads, dropout=self.dropout))
        self.rFF1 = Dense(h, 1)

    def forward(self, feed, training: bool = False, gen=None):
        feed = self.rerank_feed(feed)       # the ranker's keys (run here under --tuneranker)
        i_vectors = self.i_embeddings(feed["item_id"])
        di = torch.cat([i_vectors, feed["u_v"], feed["i_v"]], dim=2)
        # positionafter = 1 (SetRank.py:108-120)
        xi = self.rFF0(di) + self.ordinal_position_embedding(feed["position"])
        pad = feed["padding_mask"]
        for k in range(self.n_blocks):
            if self.setrank_type == "MSAB":
                xi = getattr(self, f"msab_{k}")(xi, xi, xi, key_padding_mask=pad, training=training,
                                                gen=gen)
            else:
                ind = getattr(self, f"inducing_{k}")
                ind = ind[None].expand(xi.shape[0], *ind.shape)
                h = getattr(self, f"imsab_{k}_1")(ind, xi, xi, key_padding_mask=pad, training=training,
                                                  gen=gen)
                xi = getattr(self, f"imsab_{k}_2")(xi, h, h, training=training, gen=gen)
        return {"prediction": self.rFF1(xi)[..., 0]}


@register_model("SetRankGeneral")
class SetRankGeneral(RerankModel, SetRankBase):
    def __init__(self, *, emb_size: int = 64, n_blocks: int = 4, num_heads: int = 4,
                 num_hidden_unit: int = 64, setrank_type: str = "IMSAB", **kwargs):
        super().__init__(**kwargs)
        self.init_setrank(emb_size, n_blocks, num_heads, num_hidden_unit, setrank_type)

    @staticmethod
    def parse_model_args(parser):
        return RerankModel.parse_model_args(SetRankBase.parse_model_args_setrank(parser))

    forward = SetRankBase.forward


@register_model("SetRankSequential")
class SetRankSequential(RerankSeqModel, SetRankBase):
    def __init__(self, *, emb_size: int = 64, n_blocks: int = 4, num_heads: int = 4,
                 num_hidden_unit: int = 64, setrank_type: str = "IMSAB", **kwargs):
        super().__init__(**kwargs)
        self.init_setrank(emb_size, n_blocks, num_heads, num_hidden_unit, setrank_type)

    @staticmethod
    def parse_model_args(parser):
        return RerankSeqModel.parse_model_args(SetRankBase.parse_model_args_setrank(parser))

    forward = SetRankBase.forward
