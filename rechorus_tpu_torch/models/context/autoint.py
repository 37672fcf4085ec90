"""AutoInt -- automatic feature interaction via self-attention (port of
rechorus_tpu/models/context/autoint.py).

Reference behavior: src/models/context/AutoInt.py (Song et al., CIKM'19):
stacked multi-head self-attention over the feature embeddings + a linear
residual, relu, flattened into a deep MLP; the linear terms added.
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import Dense, MLPBlock, MultiHeadAttention, _constant
from rechorus_tpu_torch.registry import register_model


class AutoIntBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "layers", "num_layers", "num_heads", "loss_n"]

    def __init__(self, *, emb_size: int = 64, attention_size: int = 32, num_heads: int = 1,
                 num_layers: int = 1, layers=(64,), **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.attention_size = emb_size, attention_size
        self.num_heads, self.num_layers, self.layers = num_heads, num_layers, tuple(layers)
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size,
                                         include_linear=True)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))
        self.PARAM_INITS = {"overall_bias": _constant(0.01)}
        d_in = emb_size
        for i in range(num_layers):
            self.add_module(f"att_{i}", MultiHeadAttention(d_in, num_heads, use_bias=False,
                                                           attention_d=attention_size))
            self.add_module(f"residual_{i}", Dense(d_in, attention_size))
            d_in = attention_size
        self.deep_layers = MLPBlock(len(self.feature_kinds) * d_in, self.layers, "ReLU",
                                    output_dim=1, dropout_rate=self.dropout)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--attention_size", type=int, default=32, help="Size of attention hidden space.")
        parser.add_argument("--num_heads", type=int, default=1, help="Number of attention heads.")
        parser.add_argument("--num_layers", type=int, default=1, help="Number of self-attention layers.")
        parser.add_argument("--layers", type=str, default="[64]", help="Size of each layer.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["layers"] = tuple(ast.literal_eval(args.layers))
        return kw

    def prediction(self, feed, training, gen):
        att_input, linear = self.linear_part(feed)            # [B, C, F, d]
        for i in range(self.num_layers):
            attention = getattr(self, f"att_{i}")(att_input, att_input, att_input)
            att_input = torch.relu(attention + getattr(self, f"residual_{i}")(att_input))
        B, C = att_input.shape[:2]
        deep = self.deep_layers(att_input.reshape(B, C, -1), training, gen)[..., 0]
        return linear + deep, None


@register_model("AutoIntCTR")
class AutoIntCTR(AutoIntBase, ContextCTRModel):
    pass


@register_model("AutoIntTopK")
class AutoIntTopK(AutoIntBase, ContextModel):
    pass
