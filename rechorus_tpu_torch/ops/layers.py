"""Shared torch blocks (port of rechorus_tpu/ops/layers.py, `embed` only).

Init convention of the reference BaseModel.init_weights
(src/models/BaseModel.py:29-35): N(0, 0.01) for embedding tables.
"""
from __future__ import annotations

from torch import nn

INIT_STD = 0.01


def embed(num: int, dim: int) -> nn.Embedding:
    """[num, dim] embedding table, N(0, 0.01) init from torch's global RNG."""
    table = nn.Embedding(num, dim)
    nn.init.normal_(table.weight, mean=0.0, std=INIT_STD)
    return table
