"""SAM -- self-attention models of feature interaction (SAM1, SAM2A,
SAM2E, SAM3A, SAM3E; port of rechorus_tpu/models/context/sam.py).

Reference behavior: src/models/context/SAM.py (Cheng & Xue, SIGIR'21;
FuxiCTR-derived SAMBlock).
"""
from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import Dense, _ones, dropout
from rechorus_tpu_torch.registry import register_model


class SAMBlock(nn.Module):
    """The interaction block over [B, C, f, d] field embeddings, then the
    aggregation (weighted / mean / sum pooling over the fields, or concat).
    Parameters as flax names them: `W` (SAM2A), `W_i` (SAM3A), `K_i` and
    `Q_i` (SAM3*), `agg_weight` (weighted pooling)."""

    def __init__(self, num_layers: int, num_fields: int, embedding_dim: int,
                 use_residual: bool = False, interaction_type: str = "SAM2E",
                 aggregation: str = "concat", dropout: float = 0.0):
        super().__init__()
        self.num_layers, self.f, self.d = num_layers, num_fields, embedding_dim
        self.use_residual, self.t, self.aggregation = use_residual, interaction_type, aggregation
        self.dropout = dropout
        self.PARAM_INITS = {}
        f, d, t = num_fields, embedding_dim, interaction_type
        if t not in ("SAM1", "SAM2A", "SAM2E", "SAM3A", "SAM3E"):
            raise ValueError(f"interaction_type={t} not supported.")
        if t == "SAM2A":
            self._ones_param("W", (f, f, d))
        if t in ("SAM3A", "SAM3E"):
            for i in range(num_layers):
                self.add_module(f"K_{i}", Dense(d, d, use_bias=False))
                if t == "SAM3A":
                    self._ones_param(f"W_{i}", (f, f, d))
                if use_residual:
                    self.add_module(f"Q_{i}", Dense(d, d, use_bias=False))
        n_out = f * f if t in ("SAM2A", "SAM2E") else f
        if aggregation == "weighted_pooling":
            self._ones_param("agg_weight", (n_out, 1))
        elif aggregation not in ("concat", "mean_pooling", "sum_pooling"):
            raise ValueError(f"aggregation={aggregation} not supported.")
        self.out_dim = n_out * d if aggregation == "concat" else d

    def _ones_param(self, name, shape):
        self.register_parameter(name, nn.Parameter(torch.ones(shape)))
        self.PARAM_INITS[name] = _ones

    def forward(self, F, training: bool = False, gen=None):
        def drop(x):
            return dropout(x, self.dropout, training, gen)

        B, C = F.shape[:2]
        t = self.t
        if t == "SAM1":
            out = F
        elif t in ("SAM2A", "SAM2E"):
            S = torch.matmul(F, F.transpose(-1, -2))                        # [B, C, f, f]
            inter = self.W if t == "SAM2A" else F[:, :, :, None, :] * F[:, :, None, :, :]
            out = drop(S[..., None] * inter).reshape(B, C, self.f * self.f, self.d)
        else:
            out = F
            for i in range(self.num_layers):
                S = torch.matmul(out, getattr(self, f"K_{i}")(out).transpose(-1, -2))
                if t == "SAM3A":
                    new = (S[..., None] * getattr(self, f"W_{i}")).sum(-2)    # [B, C, f, d]
                else:
                    new = (S[..., None] * (out[:, :, :, None, :] * out[:, :, None, :, :])).sum(-2)
                if self.use_residual:
                    new = new + getattr(self, f"Q_{i}")(out)
                out = drop(new)
        if self.aggregation == "weighted_pooling":
            return (out * self.agg_weight).sum(-2)
        if self.aggregation == "concat":
            return out.reshape(B, C, -1)
        if self.aggregation == "mean_pooling":
            return out.mean(-2)
        return out.sum(-2)


class SAMBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "loss_n", "interaction_type", "aggregation"]

    def __init__(self, *, emb_size: int = 64, interaction_type: str = "SAM2E",
                 aggregation: str = "concat", num_layers: int = 1, use_residual: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.interaction_type, self.aggregation = emb_size, interaction_type, aggregation
        self.num_layers, self.use_residual = num_layers, use_residual
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size)
        self.block = SAMBlock(num_layers, len(self.feature_names), emb_size, bool(use_residual),
                              interaction_type, aggregation, self.dropout)
        self.output_layer = Dense(self.block.out_dim, 1)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--interaction_type", type=str, default="SAM2E",
                            help="SAM2A, SAM2E, SAM3A, SAM3E, SAM1.")
        parser.add_argument("--aggregation", type=str, default="concat",
                            help="concat, weighted_pooling, mean_pooling, sum_pooling")
        parser.add_argument("--num_layers", type=int, default=1, help="Number of layers in SAM block.")
        parser.add_argument("--use_residual", type=int, default=0, help="Use residual connection in SAM block.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        agg = args.aggregation
        if args.interaction_type in ("SAM2A", "SAM2E"):
            agg = "concat"              # the reference forces this (SAM.py:41-46)
        elif args.interaction_type == "SAM1":
            agg = "weighted_pooling"
        kw["aggregation"] = agg
        return kw

    def prediction(self, feed, training, gen):
        embeddings = self.bank(*self.context_inputs(feed))
        return self.output_layer(self.block(embeddings, training, gen))[..., 0], None


@register_model("SAMCTR")
class SAMCTR(SAMBase, ContextCTRModel):
    pass


@register_model("SAMTopK")
class SAMTopK(SAMBase, ContextModel):
    pass
