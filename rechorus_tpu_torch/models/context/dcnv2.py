"""DCNv2 -- improved deep & cross: a full-matrix cross or a mixture of
low-rank experts, parallel or stacked with the deep tower (port of
rechorus_tpu/models/context/dcnv2.py).

Reference behavior: src/models/context/DCNv2.py (Wang et al., WWW'21).
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import Dense, MLPBlock, _unit_normal, _zeros
from rechorus_tpu_torch.registry import register_model


class DCNv2Base(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "loss_n", "cross_layer_num", "structure"]

    def __init__(self, *, emb_size: int = 64, layers=(64,), cross_layer_num: int = 4, mixed: int = 1,
                 structure: str = "parallel", low_rank: int = 64, expert_num: int = 2,
                 reg_weight: float = 2.0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.layers, self.cross_layer_num = emb_size, tuple(layers), cross_layer_num
        self.mixed, self.structure, self.low_rank = mixed, structure, low_rank
        self.expert_num, self.reg_weight = expert_num, reg_weight
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size)
        D = len(self.feature_kinds) * emb_size
        shapes = {"cross_b": (D,)}
        if mixed:
            E, r = expert_num, low_rank
            shapes.update(cross_u=(E, D, r), cross_v=(E, D, r), cross_c=(E, r, r))
            for e in range(expert_num):     # per expert, shared across the cross layers
                self.add_module(f"gating_{e}", Dense(D, 1))
        else:
            shapes["cross_w2"] = (D, D)
        self.PARAM_INITS = {}
        for layer in range(cross_layer_num):
            for name, shape in shapes.items():
                key = f"{name}_{layer}"
                self.register_parameter(key, nn.Parameter(torch.empty(shape)))
                self.PARAM_INITS[key] = _zeros if name == "cross_b" else _unit_normal
        self.deep_layers = MLPBlock(D, self.layers, "ReLU",
                                    dropout_rate=self.dropout, norm="batch_norm")
        width = self.deep_layers.out_dim + (D if structure == "parallel" else 0)
        self.predict_layer = Dense(width, 1)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--layers", type=str, default="[64]", help="Size of each deep layer.")
        parser.add_argument("--cross_layer_num", type=int, default=4, help="Number of cross layers.")
        parser.add_argument("--mixed", type=int, default=1, help="Whether to use mixture of low-rank experts.")
        parser.add_argument("--structure", type=str, default="parallel", help="parallel | stacked")
        parser.add_argument("--low_rank", type=int, default=64, help="Low-rank size when mixed==1.")
        parser.add_argument("--expert_num", type=int, default=2, help="Number of experts per cross layer when mixed==1.")
        parser.add_argument("--reg_weight", type=float, default=2.0, help="Regularization weight (mixed version).")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["layers"] = tuple(ast.literal_eval(args.layers))
        return kw

    def cross_net_2(self, x0):
        """x_{l+1} = x_0 * (W_l x_l + b_l) + x_l (full matrix), and
        sum_l ||W_l||_F, which the loss adds for this variant
        (reference DCNv2.py:192-198)."""
        x_l, reg = x0, 0.0
        for layer in range(self.cross_layer_num):
            w, b = getattr(self, f"cross_w2_{layer}"), getattr(self, f"cross_b_{layer}")
            x_l = x0 * (x_l @ w.T + b) + x_l
            reg = reg + torch.sqrt((w ** 2).sum())
        return x_l, reg

    def cross_net_mix(self, x0):
        """A mixture of low-rank experts with tanh in the subspace
        (reference DCNv2.py:96-145); the gating Dense is per expert, shared
        across the cross layers (reference DCNv2.py:62)."""
        x_l = x0
        for layer in range(self.cross_layer_num):
            b = getattr(self, f"cross_b_{layer}")
            U, V, Cm = (getattr(self, f"cross_{n}_{layer}") for n in "uvc")
            expert_outs, gates = [], []
            for e in range(self.expert_num):
                gates.append(getattr(self, f"gating_{e}")(x_l))            # [B, C, 1]
                xl_c = torch.tanh(torch.tanh(x_l @ V[e]) @ Cm[e].T)
                expert_outs.append(x0 * (xl_c @ U[e].T + b))
            expert_output = torch.stack(expert_outs, dim=-1)              # [B, C, D, E]
            gating = torch.softmax(torch.cat(gates, dim=-1), dim=-1)      # [B, C, E]
            x_l = x_l + (expert_output * gating[:, :, None, :]).sum(-1)
        return x_l

    def prediction(self, feed, training, gen):
        context_emb = self.flat_embeddings(feed)
        if self.mixed:
            cross_output, reg = self.cross_net_mix(context_emb), 0.0
        else:
            cross_output, reg = self.cross_net_2(context_emb)
        if self.structure == "parallel":
            deep_output = self.deep_layers(context_emb, training, gen)
            output = self.predict_layer(torch.cat([cross_output, deep_output], dim=-1))
        else:  # stacked
            output = self.predict_layer(self.deep_layers(cross_output, training, gen))
        return output[..., 0], reg


@register_model("DCNv2CTR")
class DCNv2CTR(DCNv2Base, ContextCTRModel):
    pass


@register_model("DCNv2TopK")
class DCNv2TopK(DCNv2Base, ContextModel):
    pass
