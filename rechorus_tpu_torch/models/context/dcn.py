"""DCN -- deep & cross network (port of rechorus_tpu/models/context/dcn.py).

Reference behavior: src/models/context/DCN.py (Wang et al., KDD'17): the
cross network x_{l+1} = x_0 * (w_l . x_l) + b_l + x_l beside a deep MLP with
BatchNorm before each activation (flax's BatchNorm, ops/layers.py); the
loss adds reg_weight * sum_l ||w_l||_2.
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import Dense, MLPBlock, _constant, _unit_normal
from rechorus_tpu_torch.registry import register_model


class DCNBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "loss_n", "cross_layer_num"]

    def __init__(self, *, emb_size: int = 64, layers=(64,), cross_layer_num: int = 6,
                 reg_weight: float = 2.0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.layers = emb_size, tuple(layers)
        self.cross_layer_num, self.reg_weight = cross_layer_num, reg_weight
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size)
        D = len(self.feature_kinds) * emb_size
        self.PARAM_INITS = {}
        for layer in range(cross_layer_num):
            self.register_parameter(f"cross_w_{layer}", nn.Parameter(torch.empty(D)))
            self.register_parameter(f"cross_b_{layer}", nn.Parameter(torch.empty(D)))
            self.PARAM_INITS[f"cross_w_{layer}"] = _unit_normal
            self.PARAM_INITS[f"cross_b_{layer}"] = _constant(0.01)
        self.deep_layers = MLPBlock(D, self.layers, "ReLU", dropout_rate=self.dropout,
                                    norm="batch_norm")
        self.predict_layer = Dense(D + self.deep_layers.out_dim, 1)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--layers", type=str, default="[64]", help="Size of each deep layer.")
        parser.add_argument("--cross_layer_num", type=int, default=6, help="Number of cross layers.")
        parser.add_argument("--reg_weight", type=float, default=2.0,
                            help="Regularization weight for cross-layer weights.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["layers"] = tuple(ast.literal_eval(args.layers))
        return kw

    def cross_net(self, x_0):
        x_l, reg = x_0, 0.0
        for layer in range(self.cross_layer_num):
            w, b = getattr(self, f"cross_w_{layer}"), getattr(self, f"cross_b_{layer}")
            x_l = x_0 * (x_l * w).sum(-1, keepdim=True) + b + x_l
            reg = reg + torch.sqrt((w ** 2).sum())
        return x_l, reg

    def prediction(self, feed, training, gen):
        context_emb = self.flat_embeddings(feed)
        cross_output, reg = self.cross_net(context_emb)
        deep_output = self.deep_layers(context_emb, training, gen)
        output = self.predict_layer(torch.cat([cross_output, deep_output], dim=-1))
        return output[..., 0], reg


@register_model("DCNCTR")
class DCNCTR(DCNBase, ContextCTRModel):
    pass


@register_model("DCNTopK")
class DCNTopK(DCNBase, ContextModel):
    pass
