"""Full-catalog serving API, build once and query many (port of
rechorus_tpu/serve.py:46-157).

    idx = ServeIndex.build(model, corpus, k=100)       # once, on the card
    items, scores = idx.query(user_ids)                # many

Build-time work: read the user/item tables from the torch module through
the catalog protocol (`BaseModel.supports_catalog`), build the grouped
rescore copy (`ops.topk.group_table_for_rescore`) for large catalogs,
and bake the per-user clicked-exclusion matrix.

Query: user-vector gather -> `tiled_catalog_topk` (fused bucket-max
kernel, exact bucket select, grouped rescore, clicked knockout) for
catalogs of at least `MIN_ROWS_FOR_TILED` rows, else dense scores ->
`masked_topk`.

Models whose catalog table is not the raw parameter build through
`ServeIndex.from_tables(u_table, i_table, ...)`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.ops import topk as topk_ops


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; a missing card raises (no CPU fallback)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def dense_catalog_scores(u, table, bias, n_items: int) -> torch.Tensor:
    """[B, N] catalog scores as one product; dead padded tail rows (ids >=
    n_items) masked to -inf (rechorus_tpu/runners/base.py:682-692)."""
    scores = u @ table.T
    if bias is not None:
        scores += bias[None, :]
    if table.shape[0] > n_items:
        scores[:, n_items:] = float("-inf")
    return scores


def _as_tensor(x, device, dtype):
    if x is None:
        return None
    return torch.as_tensor(x).detach().to(device=device, dtype=dtype).contiguous()


@dataclasses.dataclass
class ServeIndex:
    u_table: torch.Tensor                  # [n_users(+pad), D] float32
    i_table: torch.Tensor                  # [n_items(+pad), D] float32
    i_bias: Optional[torch.Tensor]         # [n_items(+pad)] or None
    grouped: Optional[torch.Tensor]        # [Gp, bucket, D] rescore copy
    clicked: Optional[torch.Tensor]        # [n_users, M] int32 exclusion ids
    n_items: int
    k: int = 100

    @classmethod
    def from_tables(cls, u_table, i_table, *, i_bias=None, clicked=None,
                    n_items: int | None = None, k: int = 100, device=None):
        """Tables (tensors or arrays) go to `device` as float32."""
        device = resolve_device(device)
        u_table = _as_tensor(u_table, device, torch.float32)
        i_table = _as_tensor(i_table, device, torch.float32)
        N = i_table.shape[0]
        grouped = None
        if N >= topk_ops.MIN_ROWS_FOR_TILED and N >= topk_ops.DEFAULT_BUCKET * 128:
            grouped = topk_ops.group_table_for_rescore(i_table)
        return cls(u_table=u_table, i_table=i_table,
                   i_bias=_as_tensor(i_bias, device, torch.float32),
                   grouped=grouped, clicked=_as_tensor(clicked, device, torch.int32),
                   n_items=int(n_items if n_items is not None else N), k=k)

    @classmethod
    def build(cls, model, corpus=None, *, k: int = 100, exclude_clicked: bool = True,
              device=None):
        """From a catalog-protocol model whose catalog table is the raw
        parameter table. Other models: precompute the tables and use
        `from_tables`."""
        if not getattr(model, "supports_catalog", False) or \
                not getattr(model, "catalog_raw_table", True):
            raise ValueError(
                f"{type(model).__name__} does not expose a raw catalog table; precompute "
                "(u_table, i_table) and use ServeIndex.from_tables")
        node = model
        for name in model.catalog_table:
            node = getattr(node, name)
        i_table = node.weight
        u_mod = getattr(model, "u_embeddings", None)
        if u_mod is None:
            raise ValueError("no u_embeddings table; use from_tables")
        bias = None
        for name in ("i_bias", "item_bias"):
            mod = getattr(model, name, None)
            if mod is not None:
                bias = mod.weight.reshape(-1)
                if bias.shape[0] != i_table.shape[0]:
                    raise ValueError(
                        f"{name!r} has {bias.shape[0]} rows but the item table has "
                        f"{i_table.shape[0]}; pass the bias through from_tables")
                break
        clicked = None
        if exclude_clicked and corpus is not None:
            clicked = corpus.clicked_matrix(include_residual=True)
        return cls.from_tables(u_mod.weight, i_table, i_bias=bias, clicked=clicked,
                               n_items=getattr(corpus, "n_items", None) or i_table.shape[0],
                               k=k, device=device)

    @torch.no_grad()
    def query(self, user_ids):
        """(item ids [B, k] int32, scores [B, k] float32) as numpy: top-k
        catalog items per user with clicked/pad/dead rows excluded."""
        users = torch.as_tensor(np.asarray(user_ids), dtype=torch.long).to(self.u_table.device)
        u = self.u_table[users]
        cl = None if self.clicked is None else self.clicked[users]
        if self.i_table.shape[0] >= topk_ops.MIN_ROWS_FOR_TILED:
            v, i = topk_ops.tiled_catalog_topk(
                u, self.i_table, self.k, bias=self.i_bias, clicked_rows=cl,
                n_valid=self.n_items, grouped_table=self.grouped)
        else:
            scores = dense_catalog_scores(u, self.i_table, self.i_bias, self.n_items)
            if cl is None:
                cl = torch.zeros((u.shape[0], 1), dtype=torch.int32, device=u.device)
            v, i = metrics_ops.masked_topk(scores, cl, self.k, n_valid=self.n_items)
        return i.cpu().numpy(), v.cpu().numpy()
