"""Shared torch blocks (port of rechorus_tpu/ops/layers.py:56-145:
`TableEmbed`, `embed`, the table dtype and the sparse-lookup context).

Init convention of the reference BaseModel.init_weights
(src/models/BaseModel.py:29-35): N(0, 0.01) for embedding tables.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

INIT_STD = 0.01

# process-global table storage dtype: --bf16_emb sets bfloat16 so tables
# cost half the memory. Gathered rows are cast back to f32 AFTER the
# gather, never the whole table.
_TABLE_DTYPE = None


def set_table_dtype(dt) -> None:
    global _TABLE_DTYPE
    _TABLE_DTYPE = dt


# sparse-lookup context for the --sparse_emb_grad training lane: maps
# id(table.weight) to (rows [R], row_vals [R, D] f32, fallback table or
# None, pos_map [N] or None). While set (only around the train step's
# forward), TableEmbed resolves lookups from row_vals instead of gathering
# the table, so autograd produces an [R, D] gradient and never an [N, D]
# one. Ids missing from rows (a lazy_table_specs coverage gap) fall back to
# a detached gather from the table: the forward stays exact, only that
# row's update is dropped -- the failure mode of the dense-grad lazy lane.
_SPARSE_LOOKUP: dict = {}


def set_sparse_lookup(mapping) -> None:
    global _SPARSE_LOOKUP
    _SPARSE_LOOKUP = mapping if mapping is not None else {}


class TableEmbed(nn.Module):
    """Embedding table that (a) gathers in storage dtype and casts only the
    gathered rows to f32 (so --bf16_emb never promotes the whole table),
    and (b) honors the sparse-lookup context above. Its one parameter is
    `weight`, as in nn.Embedding, so `state_dict` keys do not change."""

    def __init__(self, num: int, dim: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=dtype or torch.float32))
        with torch.no_grad():
            self.weight.copy_(torch.randn(num, dim) * INIT_STD)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        table = self.weight
        out_dtype = torch.float32 if table.dtype in (torch.bfloat16, torch.float16) \
            else table.dtype
        entry = _SPARSE_LOOKUP.get(id(table)) if _SPARSE_LOOKUP else None
        if entry is None:
            return F.embedding(inputs, table).to(out_dtype)
        # the packed-carry lane passes the [N, 3D] [p|mu|nu] block as the
        # fallback source: its first D lanes are the current parameters,
        # while this module's own `weight` is stale for the epoch
        rows, vals = entry[0], entry[1]
        fb_table = entry[2] if len(entry) > 2 and entry[2] is not None else table
        R, D = vals.shape
        if len(entry) > 3 and entry[3] is not None:
            # O(1) dense id -> slot map (ops/lazy_adam.unique_rows_hashed)
            pos = entry[3][inputs]
            hit = pos < R
            pos = pos.clamp(max=R - 1)
        else:
            pos = torch.searchsorted(rows, inputs).clamp(0, R - 1)
            hit = rows[pos] == inputs
        fallback = fb_table.detach()[:, :D][inputs]  # packed: param lanes first
        out = torch.where(hit[..., None], F.embedding(pos, vals), fallback.to(vals.dtype))
        return out.to(out_dtype)


def embed(num: int, dim: int) -> TableEmbed:
    """[num, dim] embedding table, N(0, 0.01) init from torch's global RNG,
    stored in the dtype of `set_table_dtype` (f32 unless --bf16_emb). Every
    model-level table gather should go through this: a raw `weight[ids]`
    bypasses the bf16 storage cast AND the sparse-lookup context."""
    return TableEmbed(num, dim, dtype=_TABLE_DTYPE)
