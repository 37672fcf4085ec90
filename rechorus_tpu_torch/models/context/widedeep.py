"""Wide&Deep -- FM-style wide part + a deep MLP over the flattened feature
embeddings (port of rechorus_tpu/models/context/widedeep.py).

Reference behavior: src/models/context/WideDeep.py (Cheng et al., 2016).
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import MLPBlock, _constant
from rechorus_tpu_torch.registry import register_model


class WideDeepBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "layers", "loss_n"]

    def __init__(self, *, emb_size: int = 64, layers=(64,), **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.layers = emb_size, tuple(layers)
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size,
                                         include_linear=True)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))
        self.PARAM_INITS = {"overall_bias": _constant(0.01)}
        self.deep_layers = MLPBlock(len(self.feature_kinds) * emb_size, self.layers, "ReLU",
                                    output_dim=1, dropout_rate=self.dropout)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--layers", type=str, default="[64]", help="Size of each layer.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["layers"] = tuple(ast.literal_eval(args.layers))
        return kw

    def deep(self, v, training, gen):
        """The deep tower's [B, C] score of [B, C, F, d] embeddings."""
        return self.deep_layers(v.reshape(v.shape[0], v.shape[1], -1), training, gen)[..., 0]

    def prediction(self, feed, training, gen):
        v, wide = self.linear_part(feed)
        return self.deep(v, training, gen) + wide, None


@register_model("WideDeepCTR")
class WideDeepCTR(WideDeepBase, ContextCTRModel):
    pass


@register_model("WideDeepTopK")
class WideDeepTopK(WideDeepBase, ContextModel):
    pass
