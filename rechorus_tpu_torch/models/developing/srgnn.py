"""SRGNN -- session graph + gated GNN (Wu et al., AAAI'19; port of
rechorus_tpu/models/developing/srgnn.py).

Reference behavior: src/models/developing/SRGNN.py: each history becomes
a session graph (its unique items as nodes, the in- and out-degree
normalised adjacency of consecutive transitions, SRGNN.py:43-76, built
per row on the host there); a gated GNN cell propagates the node states
(102-150); soft attention over the sequence states and the last state,
then a linear transform, scored by dot product.

The graph is built on the device for the whole batch (`build_session_graph`),
as the JAX package builds it inside its step. Every parameter and Dense
starts at U(-1/sqrt(d), 1/sqrt(d)) (reference :30-32). Row 0 of the item
table is the padding row: it reads as zeros and takes no gradient, and the
parameter keeps its drawn value (the JAX package's `.at[0].set(0.0)`). The
table is a raw parameter: `--lazy_emb_adam 1` resolves no table and the
first step raises, as in the JAX package.
CMD example:
  python -m rechorus_tpu_torch.main --model_name SRGNN --emb_size 64 --num_layers 1 --lr 1e-3 \
      --l2 1e-6 --history_max 20 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import Dense, _uniform
from rechorus_tpu_torch.parallel.mesh import take_rows
from rechorus_tpu_torch.registry import register_model


def build_session_graph(history: torch.Tensor):
    """history [B, H] -> (alias [B, H], A [B, H, 2H], nodes [B, H]), the
    JAX `build_session_graph` for a whole batch (reference _get_slice,
    SRGNN.py:43-76).

    nodes: each row's distinct items ascending, after as many pads (0) as
    the row has fewer distinct positive items than H -- what the JAX
    package's per-row `sort(unique(seq, size=H, fill_value=0))` gives,
    computed as sort, zero each element equal to its left neighbour, sort
    again. alias: each position's node index (searchsorted). A: [A_in |
    A_out] with A_in[i, j] = a[j, i] / indeg(i) and A_out[i, j] =
    a[i, j] / outdeg(i), a the 0/1 adjacency of consecutive positive
    items (a scatter-max; a transition touching a pad is sent to (0, 0)
    with value 0) and a zero degree divided by 1."""
    B, H = history.shape
    s = torch.sort(history, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    nodes = torch.sort(torch.where(dup, 0, s), dim=1).values
    alias = torch.searchsorted(nodes, history)
    ok = (history[:, :-1] > 0) & (history[:, 1:] > 0)
    u = torch.where(ok, alias[:, :-1], 0)
    v = torch.where(ok, alias[:, 1:], 0)
    flat = (torch.arange(B, device=history.device)[:, None] * (H * H) + u * H + v).reshape(-1)
    a = torch.zeros(B * H * H, device=history.device)
    a = a.scatter_reduce(0, flat, ok.reshape(-1).float(), reduce="amax").view(B, H, H)
    sum_in = a.sum(1)
    a_in = a / torch.where(sum_in == 0, 1.0, sum_in)[:, None, :]
    sum_out = a.sum(2)
    a_out = a.transpose(1, 2) / torch.where(sum_out == 0, 1.0, sum_out)[:, None, :]
    # reference: concat([A_in, A_out]).T -> [H, 2H]
    return alias, torch.cat([a_in, a_out], dim=1).transpose(1, 2), nodes


class GatedGNN(nn.Module):
    """GRU-style gated propagation over the session graph (reference GNN,
    SRGNN.py:102-150); the raw parameters keep the JAX package's names and
    axes (w_ih [2d, 3d], w_hh [d, 3d])."""

    def __init__(self, emb_size: int, step: int = 1):
        super().__init__()
        d, self.step = emb_size, step
        uni = _uniform(1.0 / d ** 0.5)
        self.PARAM_INITS = {n: uni for n in ("w_ih", "w_hh", "b_ih", "b_hh", "b_iah", "b_ioh")}
        self.w_ih = nn.Parameter(torch.empty(2 * d, 3 * d))
        self.w_hh = nn.Parameter(torch.empty(d, 3 * d))
        self.b_ih = nn.Parameter(torch.empty(3 * d))
        self.b_hh = nn.Parameter(torch.empty(3 * d))
        self.b_iah = nn.Parameter(torch.empty(d))
        self.b_ioh = nn.Parameter(torch.empty(d))
        self.linear_edge_in = Dense(d, d, kernel_init=uni, bias_init=uni)
        self.linear_edge_out = Dense(d, d, kernel_init=uni, bias_init=uni)

    def forward(self, A, hidden):
        H = A.shape[1]
        for _ in range(self.step):
            input_in = torch.matmul(A[:, :, :H], self.linear_edge_in(hidden)) + self.b_iah
            input_out = torch.matmul(A[:, :, H:], self.linear_edge_out(hidden)) + self.b_ioh
            inputs = torch.cat([input_in, input_out], dim=2)
            i_r, i_i, i_n = (inputs @ self.w_ih + self.b_ih).chunk(3, dim=2)
            h_r, h_i, h_n = (hidden @ self.w_hh + self.b_hh).chunk(3, dim=2)
            reset = torch.sigmoid(i_r + h_r)
            inputgate = torch.sigmoid(i_i + h_i)
            newgate = torch.tanh(i_n + reset * h_n)
            hidden = (1 - inputgate) * hidden + inputgate * newgate
        return hidden


@register_model("SRGNN")
class SRGNN(SequentialModel):
    extra_log_args: ClassVar[list] = ["num_layers"]

    def __init__(self, *, emb_size: int = 64, num_layers: int = 1, **kwargs):
        super().__init__(**kwargs)
        d = self.emb_size = emb_size
        self.num_layers = num_layers
        uni = _uniform(1.0 / d ** 0.5)
        self.PARAM_INITS = {"i_embeddings": uni}
        self.i_embeddings = nn.Parameter(torch.empty(self.item_num, d))
        self.gnn = GatedGNN(d, num_layers)
        self.linear1 = Dense(d, d, kernel_init=uni, bias_init=uni)
        self.linear2 = Dense(d, d, kernel_init=uni, bias_init=uni)
        self.linear3 = Dense(d, 1, use_bias=False, kernel_init=uni)
        self.linear_transform = Dense(2 * d, d, kernel_init=uni, bias_init=uni)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--num_layers", type=int, default=1, help="Number of GNN steps.")
        return SequentialModel.parse_model_args(parser)

    def _rows(self, ids):
        """Item table rows with row 0 (padding_idx, reference :36) read as
        zeros: a functional zeroing, so row 0 gets no gradient."""
        return torch.where(ids[..., None] > 0, take_rows(self.i_embeddings, ids), 0.0)

    def forward(self, feed, training: bool = False, gen=None):
        history, lengths = feed["history_items"], feed["lengths"]
        B = history.shape[0]
        valid = history > 0
        alias, A, nodes = build_session_graph(history)
        hidden = self.gnn(A, self._rows(nodes))
        d = hidden.shape[2]
        seq_hidden = hidden.gather(1, alias[:, :, None].expand(-1, -1, d))   # [B, H, d]
        last = (lengths - 1).clamp(min=0)
        ht = seq_hidden.gather(1, last[:, None, None].expand(B, 1, d))[:, 0]
        alpha = self.linear3(torch.sigmoid(self.linear1(ht)[:, None, :] + self.linear2(seq_hidden)))
        a = (alpha * seq_hidden * valid[:, :, None]).sum(1)
        his_vector = self.linear_transform(torch.cat([a, ht], dim=1))
        i_vectors = self._rows(feed["item_id"])
        return {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}
