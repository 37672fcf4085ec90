"""FM -- factorization machines over context features (port of
rechorus_tpu/models/context/fm.py).

Reference behavior: src/models/context/FM.py (Rendle, ICDM'10): per-feature
embeddings (one fused table, see ops/feature_bank.py), FM interaction
0.5 * ((sum v)^2 - sum v^2), linear terms + overall bias.
Modes: FMCTR (sigmoid + BCE), FMTopK (ranking).
"""
from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead, fm_interaction
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import _constant
from rechorus_tpu_torch.registry import register_model


class FMBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "loss_n"]

    def __init__(self, *, emb_size: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.emb_size = emb_size
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size,
                                         include_linear=True)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))
        self.PARAM_INITS = {"overall_bias": _constant(0.01)}

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        return parser

    def prediction(self, feed, training, gen):
        v, linear = self.linear_part(feed)
        return linear + fm_interaction(v), None


@register_model("FMCTR")
class FMCTR(FMBase, ContextCTRModel):
    pass


@register_model("FMTopK")
class FMTopK(FMBase, ContextModel):
    pass
