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
`masked_topk`. With `approx=True` both select approximately
(`ops.topk.approx_max_k` at `recall_target`, the approx lane).

Models whose catalog table is not the raw parameter build through
`ServeIndex.from_tables(u_table, i_table, ...)`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.ops import topk as topk_ops
from rechorus_tpu_torch.utils.spans import span, spanned


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; a missing card raises (no CPU fallback)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def dense_catalog_scores(u, table, bias, n_items: int) -> torch.Tensor:
    """[B, N] catalog scores as one product; dead padded tail rows (ids >=
    n_items) masked to -inf (rechorus_tpu/runners/base.py:682-692). A
    multi-interest model's u [B, K, d] scores each item by the max over its
    K rows."""
    scores = CT.interest_scores(u, table) if u.dim() == 3 else u @ table.T
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
    approx: bool = False
    recall_target: float = 0.98

    @classmethod
    def from_tables(cls, u_table, i_table, *, i_bias=None, clicked=None,
                    n_items: int | None = None, k: int = 100, approx: bool = False,
                    recall_target: float = 0.98, device=None):
        """Tables (tensors or arrays) go to `device` as float32."""
        device = resolve_device(device)
        u_table = _as_tensor(u_table, device, torch.float32)
        i_table = _as_tensor(i_table, device, torch.float32)
        return cls(u_table=u_table, i_table=i_table,
                   i_bias=_as_tensor(i_bias, device, torch.float32),
                   grouped=topk_ops.rescore_copy(i_table),
                   clicked=_as_tensor(clicked, device, torch.int32),
                   n_items=int(n_items if n_items is not None else i_table.shape[0]), k=k,
                   approx=approx, recall_target=recall_target)

    @classmethod
    def build(cls, model, corpus=None, *, k: int = 100, approx: bool = False,
              recall_target: float = 0.98, exclude_clicked: bool = True, device=None):
        """From a catalog-protocol model whose catalog table is the raw
        parameter table. Other models: precompute the tables and use
        `from_tables`."""
        if getattr(model, "multi_interest", False):
            raise ValueError(
                f"{type(model).__name__} is a multi-interest model: its K user vectors are "
                "computed from each request's history, and a ServeIndex serves one stored vector "
                "a user; rank it through BaseRunner.predict_topk (--test_all 1)")
        if not getattr(model, "supports_catalog", False) or \
                not getattr(model, "catalog_raw_table", True):
            raise ValueError(
                f"{type(model).__name__} does not expose a raw catalog table; precompute "
                "(u_table, i_table) and use ServeIndex.from_tables")
        i_table = model.catalog_item_table()
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
                               k=k, approx=approx, recall_target=recall_target, device=device)

    @spanned("serve.query")
    @torch.no_grad()
    def query(self, user_ids):
        """(item ids [B, k] int32, scores [B, k] float32) as numpy: top-k
        catalog items per user with clicked/pad/dead rows excluded."""
        with span("serve.feed"):
            users = torch.as_tensor(np.asarray(user_ids), dtype=torch.long).to(self.u_table.device)
            u = self.u_table[users]
            cl = None if self.clicked is None else self.clicked[users]
        if self.i_table.shape[0] >= topk_ops.MIN_ROWS_FOR_TILED:
            v, i = topk_ops.tiled_catalog_topk(
                u, self.i_table, self.k, grouped_table=self.grouped, bias=self.i_bias,
                clicked_rows=cl, n_valid=self.n_items, approx=self.approx,
                recall_target=self.recall_target)
        else:
            scores = dense_catalog_scores(u, self.i_table, self.i_bias, self.n_items)
            if cl is None:
                cl = torch.zeros((u.shape[0], 1), dtype=torch.int32, device=u.device)
            v, i = metrics_ops.masked_topk(scores, cl, self.k, n_valid=self.n_items,
                                           approx=self.approx, recall_target=self.recall_target)
        with span("serve.results"):
            return _to_host(i, v)


def _to_host(*ts):
    """The tensors `ts` (all on one device) as host numpy arrays. From the
    card they go through pinned blocks of torch's caching host allocator,
    one non-blocking copy each and one stream synchronise. On an H100 a
    pageable `.cpu()` of a 4,096-user batch's results took 2.3 ms in place
    of 0.46 in most batches of some serving processes; through pinned
    blocks every batch ran at the card's pace."""
    if ts[0].device.type != "cuda":
        return tuple(t.cpu().numpy() for t in ts)
    hs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in ts]
    for h, t in zip(hs, ts):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(ts[0].device).synchronize()
    return tuple(h.numpy() for h in hs)
