"""AFM -- attentional factorization machines (port of
rechorus_tpu/models/context/afm.py).

Reference behavior: src/models/context/AFM.py (Xiao et al., IJCAI'17):
pairwise feature interactions weighted by AttLayer attention + projection
p; the loss adds reg_weight * ||attlayer.w||_2 (through the output's
`reg_loss`, as in the JAX package).
"""
from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import AttLayer, _constant, _unit_normal, dropout
from rechorus_tpu_torch.registry import register_model


class AFMBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "attention_size", "loss_n"]

    def __init__(self, *, emb_size: int = 64, attention_size: int = 64, reg_weight: float = 2.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.attention_size, self.reg_weight = emb_size, attention_size, reg_weight
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size,
                                         include_linear=True)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))
        self.attlayer = AttLayer(emb_size, attention_size)
        self.p = nn.Parameter(torch.empty(emb_size))
        self.PARAM_INITS = {"overall_bias": _constant(0.01), "p": _unit_normal}
        F = len(self.feature_kinds)
        self.register_buffer("pairs", torch.triu_indices(F, F, offset=1), persistent=False)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--attention_size", type=int, default=64, help="Size of attention embedding vectors.")
        parser.add_argument("--reg_weight", type=float, default=2.0,
                            help="Regularization weight for attention layer weights.")
        return parser

    def prediction(self, feed, training, gen):
        v, linear = self.linear_part(feed)
        pair_wise_inter = v[..., self.pairs[0], :] * v[..., self.pairs[1], :]   # [B, C, P, d]
        att_signal = self.attlayer(pair_wise_inter)[..., None]
        att_pooling = dropout((att_signal * pair_wise_inter).sum(-2), self.dropout, training, gen)
        afm_out = (att_pooling * self.p).sum(-1)
        # L2 of the attention projection (reference AFM.py:105)
        return linear + afm_out, torch.sqrt((self.attlayer.w.weight ** 2).sum())


@register_model("AFMCTR")
class AFMCTR(AFMBase, ContextCTRModel):
    pass


@register_model("AFMTopK")
class AFMTopK(AFMBase, ContextModel):
    pass
