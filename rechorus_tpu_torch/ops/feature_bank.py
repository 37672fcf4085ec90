"""Fused context-feature embedding bank (port of
rechorus_tpu/ops/feature_bank.py).

The reference keeps a ModuleDict with one nn.Embedding per categorical
feature and one nn.Linear(1, d) per float feature (src/models/context/
FM.py:34-42). Here all categorical vocabularies are fused into ONE table
with per-feature offsets (one gather), and the stacked per-feature tensor
[B, C, F, d] is put back into the reference's canonical feature order.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from rechorus_tpu_torch.ops.layers import Dense, embed


class FeatureEmbeddingBank(nn.Module):
    """Embeds packed context features.

    Inputs (from `_ContextFields.context_inputs`):
      cat_ids:    [B, C, F_cat] int64 with vocab offsets already applied
      float_vals: [B, C, F_float] float32
    `kinds` is the static tuple of 'cat' | 'float' in canonical order.
    Output: [B, C, F, vec_size] stacked in canonical order (+ [B, C, F]
    linear terms if include_linear). Modules as the flax bank names them:
    `fused_table`, `float_emb_j` (Dense(1 -> d), no bias), and with the
    linear terms `fused_linear` ([vocab, 1]) and `float_lin_j`.
    """

    def __init__(self, total_vocab: int, kinds: Tuple[str, ...], vec_size: int,
                 include_linear: bool = False):
        super().__init__()
        self.kinds, self.include_linear = tuple(kinds), include_linear
        n_cat = sum(k == "cat" for k in self.kinds)
        n_float = len(self.kinds) - n_cat
        self.fused_table = embed(total_vocab, vec_size) if n_cat else None
        for j in range(n_float):
            self.add_module(f"float_emb_{j}", Dense(1, vec_size, use_bias=False))
        if include_linear:
            self.fused_linear = embed(total_vocab, 1) if n_cat else None
            for j in range(n_float):
                self.add_module(f"float_lin_{j}", Dense(1, 1, use_bias=False))
        self.n_float = n_float
        # canonical position -> row of [cat stack | float stack]
        ci, fi, order = 0, n_cat, []
        for k in self.kinds:
            if k == "cat":
                order.append(ci)
                ci += 1
            else:
                order.append(fi)
                fi += 1
        self.register_buffer("order", torch.tensor(order, dtype=torch.long), persistent=False)

    def _stack(self, table, prefix: str, cat_ids, float_vals) -> torch.Tensor:
        parts = []
        if table is not None:
            parts.append(table(cat_ids))                               # [B, C, F_cat, d]
        for j in range(self.n_float):
            parts.append(getattr(self, f"{prefix}_{j}")(float_vals[..., j: j + 1])[..., None, :])
        return torch.cat(parts, dim=-2).index_select(-2, self.order)

    def forward(self, cat_ids: torch.Tensor, float_vals: torch.Tensor):
        stacked = self._stack(self.fused_table, "float_emb", cat_ids, float_vals)
        if not self.include_linear:
            return stacked
        return stacked, self._stack(self.fused_linear, "float_lin", cat_ids, float_vals)[..., 0]
