"""LightGCN -- simplified graph convolution over the user-item bipartite
graph (port of rechorus_tpu/models/general/lightgcn.py: `LightGCN` and
`LightGCNImpression`).

Reference behavior: src/models/general/LightGCN.py (He et al., SIGIR'20):
the symmetric-normalized adjacency D^-1/2 A D^-1/2 over the
(n_users + n_items) nodes built from the train interactions, K
propagation layers, the final embedding the mean of all layer outputs,
dot-product scoring.

The edge list is built on the host (`build_edges`, vectorised, equal to
the JAX package's array for array) and kept on the device as buffers
sorted by row. A layer is a row-segment sum of vals * x[cols]
(`torch.segment_reduce` over the CSR row offsets: each row summed in edge
order by one thread, deterministic on the card, with no atomics); its
gradient is the same product, as the normalized adjacency is symmetric.
The catalog protocol scores against the propagated item table
(`catalog_item_table`). Under no_grad (evaluation) the propagation is
computed once per parameter version and reused across batches.
CMD example:
  python -m rechorus_tpu_torch.main --model_name LightGCN --emb_size 64 --n_layers 3 \
      --lr 1e-3 --l2 1e-8 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

import numpy as np
import torch
from torch import nn

from rechorus_tpu_torch.models.base import GeneralModel, ImpressionModel
from rechorus_tpu_torch.ops.layers import _glorot_uniform
from rechorus_tpu_torch.registry import register_model


def build_edges(n_users: int, n_items: int, train_clicked_set) -> dict:
    """Symmetric-normalized bipartite edge list (reference build_adjmat,
    LightGCN.py:22-53, selfloop_flag=False) over the nodes [users | items +
    n_users], from the CSR clicked sets (users ascending, items sorted):
    {"rows", "cols": int32 [E], "vals": float32 [E]}, sorted by row
    (stable), as the JAX package's Python loop builds them."""
    counts = np.diff(train_clicked_set.offsets)
    u = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    i = np.asarray(train_clicked_set.flat, dtype=np.int32) + n_users
    rows = np.concatenate([u, i])
    cols = np.concatenate([i, u])
    n = n_users + n_items
    deg = np.bincount(rows, minlength=n).astype(np.float64) + 1e-10
    d_inv_sqrt = np.power(deg, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    vals = (d_inv_sqrt[rows] * d_inv_sqrt[cols]).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    return {"rows": rows[order], "cols": cols[order], "vals": vals[order]}


def _segment_product(x, cols, vals, offsets):
    """out[r] = sum over the edges e of row r of vals[e] * x[cols[e]]."""
    return torch.segment_reduce(vals[:, None] * x[cols], "sum", offsets=offsets, axis=0,
                                unsafe=True)


class _SymmetricPropagate(torch.autograd.Function):
    """A @ x for the symmetric sparse A (row-sorted edges); the gradient is
    A^T @ g = A @ g, the same deterministic segment sum."""

    @staticmethod
    def forward(ctx, x, cols, vals, offsets):
        ctx.save_for_backward(cols, vals, offsets)
        return _segment_product(x, cols, vals, offsets)

    @staticmethod
    def backward(ctx, g):
        cols, vals, offsets = ctx.saved_tensors
        return _segment_product(g.contiguous(), cols, vals, offsets), None, None, None


class LightGCNBase:
    """The graph, the two tables and the propagation, shared by LightGCN and
    LightGCNImpression (JAX `LightGCNBase`)."""

    PARAM_INITS = {"user_emb": _glorot_uniform, "item_emb": _glorot_uniform}

    def init_graph(self, emb_size: int, n_layers: int, edges) -> None:
        self.emb_size, self.n_layers = emb_size, n_layers
        self.user_emb = nn.Parameter(torch.empty(self.user_num, emb_size))
        self.item_emb = nn.Parameter(torch.empty(self.item_num, emb_size))
        if edges is None:
            edges = {"rows": np.zeros(0, np.int32), "cols": np.zeros(0, np.int32),
                     "vals": np.zeros(0, np.float32)}
        n = self.user_num + self.item_num
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(edges["rows"], minlength=n), out=offsets[1:])
        # derived from the corpus, rebuilt with the model: not in the state_dict
        for name, value in (("edge_cols", edges["cols"].astype(np.int64)),
                            ("edge_vals", edges["vals"]), ("row_offsets", offsets)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(value)),
                                 persistent=False)
        self._cache = (None, None)

    def flax_constants(self) -> dict:
        """The JAX package's `constants` collection (the symmetric edge
        list, rows ascending), for its checkpoint file."""
        offsets = self.row_offsets.cpu().numpy()
        rows = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets)).astype(np.int32)
        return {"rows": rows, "cols": self.edge_cols.cpu().numpy().astype(np.int32),
                "vals": self.edge_vals.cpu().numpy()}

    @staticmethod
    def parse_model_args_base(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--n_layers", type=int, default=3, help="Number of LightGCN layers.")
        return parser

    @staticmethod
    def graph_kwargs(corpus):
        return {"edges": build_edges(corpus.n_users, corpus.n_items, corpus.train_clicked_set)}

    def propagate(self):
        """(users [n_users, d], items [n_items, d]): the mean of the K + 1
        layer outputs over the full node set."""
        ego = torch.cat([self.user_emb, self.item_emb], dim=0)
        acc = ego
        for _ in range(self.n_layers):
            ego = _SymmetricPropagate.apply(ego, self.edge_cols, self.edge_vals, self.row_offsets)
            acc = acc + ego
        all_emb = acc / (self.n_layers + 1)
        return all_emb[: self.user_num], all_emb[self.user_num:]

    def _propagated(self):
        """`propagate()`, reused under no_grad while the parameters are
        unchanged (evaluation calls it once per batch)."""
        if torch.is_grad_enabled():
            return self.propagate()
        key = tuple((p.data_ptr(), p._version) for p in (self.user_emb, self.item_emb))
        if self._cache[0] != key:
            self._cache = (key, self.propagate())
        return self._cache[1]


@register_model("LightGCN")
class LightGCN(GeneralModel, LightGCNBase):
    extra_log_args: ClassVar[list] = ["emb_size", "n_layers", "batch_size"]
    supports_catalog: ClassVar[bool] = True
    catalog_raw_table: ClassVar[bool] = False   # scores against the propagated table

    def __init__(self, *, emb_size: int = 64, n_layers: int = 3, edges=None, **kwargs):
        super().__init__(**kwargs)
        self.init_graph(emb_size, n_layers, edges)

    @staticmethod
    def parse_model_args(parser):
        return GeneralModel.parse_model_args(LightGCNBase.parse_model_args_base(parser))

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        return {**super().corpus_kwargs(args, corpus), **cls.graph_kwargs(corpus)}

    def lazy_table_specs(self) -> dict:
        # out of --lazy_emb_adam: the propagation back-propagates into every
        # user and item row each step, so a touched-rows update is the
        # whole table anyway
        return {}

    def catalog_item_table(self, local: bool = False) -> torch.Tensor:
        return self._propagated()[1].detach().float().contiguous()

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        user_all, item_all = self._propagated()
        u_embed = user_all[feed["user_id"]]                          # [B, d]
        if catalog:
            return {"u_v": u_embed}
        i_embed = item_all[feed["item_id"]]                          # [B, C, d]
        return {"prediction": (u_embed[:, None, :] * i_embed).sum(-1)}


@register_model("LightGCNImpression")
class LightGCNImpression(ImpressionModel, LightGCNBase):
    """Impression-mode LightGCN (reference LightGCN.py:93-108), with the
    re-rankers' 'u_v' and 'i_v'. Its lazy tables are ImpressionModel's,
    which its parameters lack: --lazy_emb_adam 1 resolves no table and the
    first step raises, as in the JAX package."""

    extra_log_args: ClassVar[list] = ["emb_size", "n_layers", "batch_size"]

    def __init__(self, *, emb_size: int = 64, n_layers: int = 3, edges=None, **kwargs):
        super().__init__(**kwargs)
        self.init_graph(emb_size, n_layers, edges)

    @staticmethod
    def parse_model_args(parser):
        return ImpressionModel.parse_model_args(LightGCNBase.parse_model_args_base(parser))

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        return {**super().corpus_kwargs(args, corpus), **cls.graph_kwargs(corpus)}

    def forward(self, feed, training: bool = False, gen=None):
        user_all, item_all = self._propagated()
        u_embed = user_all[feed["user_id"]]
        i_embed = item_all[feed["item_id"]]
        return {"prediction": (u_embed[:, None, :] * i_embed).sum(-1),
                "u_v": u_embed[:, None, :].expand(i_embed.shape), "i_v": i_embed}
