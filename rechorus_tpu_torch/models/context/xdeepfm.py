"""xDeepFM -- compressed interaction network + deep tower + FM (port of
rechorus_tpu/models/context/xdeepfm.py).

Reference behavior: src/models/context/xDeepFM.py (Lian et al., KDD'18).
The reference computes the CIN per candidate item in a Python loop and
drops both the CIN output from the final sum and all but the last item's
CIN result; the JAX package vectorises the CIN over the candidate axis and
ADDS its output, as the paper does, and the port follows the JAX package
(ROADMAP C, "Torch ReChorus departures"). The reference's reg_loss (deep,
linear and CIN kernel L2 norms) is emitted as well.
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead, fm_interaction
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import Dense, MLPBlock, _constant
from rechorus_tpu_torch.parallel.mesh import full_table
from rechorus_tpu_torch.registry import register_model


class XDeepFMBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "layers", "loss_n"]

    def __init__(self, *, emb_size: int = 64, layers=(64,), cin_layer_size=(8, 8), direct: int = 0,
                 reg_weight: float = 2.0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.layers = emb_size, tuple(layers)
        self.cin_layer_size, self.direct, self.reg_weight = tuple(cin_layer_size), direct, reg_weight
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size,
                                         include_linear=True)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))
        self.PARAM_INITS = {"overall_bias": _constant(0.01)}
        F = len(self.feature_kinds)
        self.deep_layers = MLPBlock(F * emb_size, self.layers, "ReLU", output_dim=1,
                                    dropout_rate=self.dropout)
        fields, final_len = F, 0
        for i, size in enumerate(self.cin_layer_size):
            self.register_parameter(f"cin_w_{i}", nn.Parameter(torch.empty(size, fields * F)))
            self.register_parameter(f"cin_b_{i}", nn.Parameter(torch.empty(size)))
            if direct or i == len(self.cin_layer_size) - 1:
                fields, final_len = size, final_len + size
            else:
                fields, final_len = size // 2, final_len + size - size // 2
        self.cin_linear = Dense(final_len, 1)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--layers", type=str, default="[64]", help="Size of each layer.")
        parser.add_argument("--cin_layers", type=str, default="[8,8]", help="Size of each CIN layer.")
        parser.add_argument("--direct", type=int, default=0,
                            help="Whether utilize the output of current network for the next layer.")
        parser.add_argument("--reg_weight", type=float, default=2.0, help="The weight of regularization loss term.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        cin = list(ast.literal_eval(args.cin_layers))
        if not args.direct:
            cin = [int(x // 2 * 2) for x in cin]
        kw.update(layers=tuple(ast.literal_eval(args.layers)), cin_layer_size=tuple(cin))
        return kw

    def cin(self, x0):
        """Compressed interaction network over x0 [B, C, F, d]: per layer
        the field-pair products of the hidden state and x0, a 1x1
        convolution over the (h * F) channels, relu, and (unless `direct`)
        a split into the next hidden state and the direct output. Returns
        ([B, C, final_len] sums over d, sum of the kernels' L2 norms)."""
        B, C, F, d = x0.shape
        hidden, finals, reg = x0, [], 0.0
        n = len(self.cin_layer_size)
        for i, size in enumerate(self.cin_layer_size):
            z = (hidden[:, :, :, None, :] * x0[:, :, None, :, :]).reshape(B, C, -1, d)
            w, b = getattr(self, f"cin_w_{i}"), getattr(self, f"cin_b_{i}")
            out = torch.relu(torch.matmul(w, z) + b[:, None])              # [B, C, size, d]
            reg = reg + torch.sqrt((w ** 2).sum())
            if self.direct:
                direct_connect = hidden = out
            elif i != n - 1:
                hidden, direct_connect = out[:, :, : size // 2], out[:, :, size // 2:]
            else:
                direct_connect = out
            finals.append(direct_connect)
        return torch.cat(finals, dim=2).sum(-1), reg

    def prediction(self, feed, training, gen):
        v, linear = self.linear_part(feed)
        fm_prediction = linear + fm_interaction(v)
        B, C = v.shape[:2]
        deep_prediction = self.deep_layers(v.reshape(B, C, -1), training, gen)[..., 0]
        cin_output, reg = self.cin(v)
        cin_prediction = self.cin_linear(cin_output)[..., 0]
        # the reference reg_loss (xDeepFM.py:76-93) also covers the deep
        # MLP's kernels and each feature's linear table, as separate norms
        deep = self.deep_layers
        for i in range(deep.n_hidden):
            reg = reg + torch.sqrt((getattr(deep, f"dense_{i}").weight ** 2).sum())
        reg = reg + torch.sqrt((deep.head.weight ** 2).sum())
        lin = full_table(self.bank.fused_linear.weight)
        offs = list(self.feature_offsets) + [self.total_vocab]
        for a, b in zip(offs[:-1], offs[1:]):
            reg = reg + torch.sqrt((lin[a:b] ** 2).sum())
        for j in range(self.bank.n_float):
            reg = reg + torch.sqrt((getattr(self.bank, f"float_lin_{j}").weight ** 2).sum())
        return fm_prediction + deep_prediction + cin_prediction, reg


@register_model("xDeepFMCTR")
class XDeepFMCTR(XDeepFMBase, ContextCTRModel):
    pass


@register_model("xDeepFMTopK")
class XDeepFMTopK(XDeepFMBase, ContextModel):
    pass
