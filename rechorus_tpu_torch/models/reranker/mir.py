"""MIR -- multi-level interaction re-ranking (port of
rechorus_tpu/models/reranker/mir.py).

Reference behavior: src/models/reranker/MIR.py (Xi et al., 2022):
intra-set multihead attention over the candidates, a BiLSTM over the
positive history (intra-list), the SLAttention set <-> list cross
interaction with a learned time decay, and a 4-layer MLP head. It needs
the history: both modes use ImpressionSeqReader (reference MIR.py:183-201).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rechorus_tpu_torch.models.base import RerankSeqModel
from rechorus_tpu_torch.ops.layers import BiLSTM, Dense, MultiHeadAttention, dropout, embed
from rechorus_tpu_torch.registry import register_model


class SLAttention(nn.Module):
    """Set <-> list co-attention with an exponential time decay (reference
    MIR.py:19-80). V [B, Lv, v_dim] the candidates, Q [B, Lq, q_dim] the
    history, time [B, Lq], usr_prof [B, prof_dim]."""

    def __init__(self, v_dim: int, q_dim: int, prof_dim: int, decay: bool = True):
        super().__init__()
        self.decay = decay
        self.w_b = nn.Parameter(torch.empty(q_dim, v_dim))
        if decay:
            self.fc_decay1 = Dense(prof_dim, 32)
            self.fc_decay2 = Dense(32, 1)
        self.w_v = nn.Parameter(torch.empty(v_dim, 1))
        self.w_q = nn.Parameter(torch.empty(q_dim, 1))

    def forward(self, V, Q, time, usr_prof):
        B, Lv, Lq = V.shape[0], V.shape[1], Q.shape[1]
        C1 = torch.einsum("bqd,de,bve->bqv", Q, self.w_b, V)                   # [B, Lq, Lv]
        if self.decay:
            theta = F.leaky_relu(self.fc_decay2(F.leaky_relu(self.fc_decay1(usr_prof))))   # [B, 1]
            C = torch.tanh(C1 * torch.exp(-theta[:, :, None] * time[:, :, None]) + C1)
        else:
            C = C1
        hv_1 = (V @ self.w_v).expand(B, Lv, Lv)
        hq_1 = (Q @ self.w_q).expand(B, Lq, Lv).transpose(1, 2)                # [B, Lv, Lq]
        h_v = torch.tanh(hv_1 + torch.einsum("bvq,bqw->bvw", hq_1, C))
        h_q = torch.tanh(hq_1 + torch.einsum("bvw,bwq->bvq", hv_1, C.transpose(1, 2)))
        v = torch.einsum("bvw,bwd->bvd", torch.softmax(h_v, dim=-1), V)
        q = torch.einsum("bvq,bqd->bvd", torch.softmax(h_q, dim=-1), Q)
        return v, q


class MIRBase:
    @staticmethod
    def parse_model_args_mir(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of item embedding vectors.")
        parser.add_argument("--num_heads", type=int, default=4, help="Number of attention heads.")
        parser.add_argument("--num_hidden_unit", type=int, default=64, help="Hidden units in attention/BiLSTM.")
        return parser

    def init_mir(self, emb_size: int, num_heads: int, num_hidden_unit: int) -> None:
        self.emb_size, self.num_heads, self.num_hidden_unit = emb_size, num_heads, num_hidden_unit
        d = emb_size + self.ranker_emb_size
        v_dim, q_dim = 2 * d, 2 * num_hidden_unit + d
        self.i_embeddings = embed(self.item_num, emb_size)
        self.intra_set = MultiHeadAttention(d, num_heads, out_proj=True)
        self.intra_list = BiLSTM(d, num_hidden_unit)
        self.SLAttention = SLAttention(v_dim, q_dim, self.ranker_emb_size)
        self.fc1 = Dense(d + v_dim + q_dim, 500)
        self.fc2 = Dense(500, 200)
        self.fc3 = Dense(200, 80)
        self.fc4 = Dense(80, 1)

    def forward(self, feed, training: bool = False, gen=None):
        feed = self.rerank_feed(feed)       # the ranker's keys (run here under --tuneranker)
        i_v = torch.cat([self.i_embeddings(feed["item_id"]), feed["i_v"]], dim=2)          # [B, Lv, d]
        his_v = torch.cat([self.i_embeddings(feed["history_items"]), feed["his_v"]], dim=2)
        seq_v = feed["u_v"][:, 0, :]                                                    # user profile
        valid = ~feed["padding_mask"]
        # intra-set attention over the candidates, the pads masked
        attn_i = self.intra_set(i_v, i_v, i_v, mask=valid[:, None, None, :]) * valid[:, :, None]
        seq = torch.cat([i_v, attn_i], dim=2)
        # intra-list BiLSTM over the history
        usr_seq = torch.cat([self.intra_list(his_v, feed["lengths"]), his_v], dim=2)
        # time transform (reference MIR.py:160-165)
        ht = feed["history_times"].to(torch.float32)
        tmax = torch.log2(ht.amax(dim=1, keepdim=True) - ht + 1)
        tmax = tmax + tmax.amax(dim=1, keepdim=True) + 1
        v, q = self.SLAttention(seq, usr_seq, tmax * (ht > 0).float(), seq_v)
        final = torch.cat([i_v, v, q], dim=2)
        final = F.layer_norm(final, final.shape[-1:], eps=1e-5)   # no scale, no bias
        x = final
        for fc in (self.fc1, self.fc2, self.fc3):
            x = dropout(torch.relu(fc(x)), self.dropout, training, gen)
        return {"prediction": self.fc4(x)[..., 0]}


@register_model("MIRGeneral")
class MIRGeneral(RerankSeqModel, MIRBase):
    def __init__(self, *, emb_size: int = 64, num_heads: int = 4, num_hidden_unit: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.init_mir(emb_size, num_heads, num_hidden_unit)

    @staticmethod
    def parse_model_args(parser):
        return RerankSeqModel.parse_model_args(MIRBase.parse_model_args_mir(parser))

    forward = MIRBase.forward


@register_model("MIRSequential")
class MIRSequential(MIRGeneral):
    pass
