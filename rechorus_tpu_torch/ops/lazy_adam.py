"""Touched-rows-only ("lazy") Adam for embedding tables (port of
rechorus_tpu/ops/lazy_adam.py).

At production scale the optimizer sweep dominates training: a dense Adam
step on a 1M x 64 table reads grad+param+mu+nu and writes param+mu+nu for
rows that are almost all untouched (a 4096-batch touches <1% of rows).
Lazy Adam updates ONLY the rows the batch touched: gather their
grad/mu/nu rows, run the Adam math on [R, D], write back.

Semantics vs dense Adam (why the lane is flag-gated behind
`--lazy_emb_adam`): untouched rows skip the mu/nu decay and, with l2 > 0,
the weight decay. This matches tf LazyAdam / torch SparseAdam.

Parameters are a dict {state_dict key: tensor} (the flax tree's paths
become those keys; weights.FLAX_TO_TORCH is the dictionary between the
two) and the moments two dicts with the same keys. Unlike the JAX
functions, which return new trees, every step here UPDATES ITS TENSORS IN
PLACE and returns the same containers; call them under
`torch.no_grad()`.

The Adam arithmetic keeps the JAX order of operations per lane
(`mr / bc1`, `sqrt(vr / bc2) + eps`, eps outside the root) in one shared
function, so the packed and the three-scatter lanes are bit-equal in f32.

The sparse lanes commit through `cuda_scatter.scatter_rows` (kernel B4):
three launches per table per step in the three-scatter lane, one in the
packed lane.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from rechorus_tpu_torch.ops.cuda_scatter import scatter_rows

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class LazyAdamState:
    count: int   # shared Adam step for bias correction
    mu: Params
    nu: Params


class LazyAdamTx:
    """Hyperparameters of the lazy path plus `.init`. Updates go through
    `lazy_adam_step` / `lazy_adam_sparse_step(_packed)` because they need
    the touched-row ids."""

    def __init__(self, lr: float, l2: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, decay_mask=None):
        self.lr, self.l2 = lr, l2
        self.b1, self.b2, self.eps = b1, b2, eps
        # {key: bool} (or a callable of the params giving it), the mask of
        # runners/base.py::build_optimizer: which leaves receive l2
        self.decay_mask = decay_mask

    def init(self, params: Params) -> LazyAdamState:
        # moments in f32 even for bf16-stored tables (--bf16_emb): the Adam
        # math runs in f32 and only the param write rounds to storage dtype
        def zeros(p):
            dt = torch.float32 if p.dtype in (torch.bfloat16, torch.float16) else p.dtype
            return torch.zeros(p.shape, dtype=dt, device=p.device)

        return LazyAdamState(count=0, mu={k: zeros(p) for k, p in params.items()},
                             nu={k: zeros(p) for k, p in params.items()})


def bias_corrections(b1: float, b2: float, count: int):
    """(1 - b1^t, 1 - b2^t) rounded as optax and the JAX package round
    them: the decays and the step as float32 (0.999 is not a float32, and
    1 - b2^t keeps that error at 1e-5 relative)."""
    t = np.float32(count)
    return (float(np.float32(1) - np.float32(b1) ** t),
            float(np.float32(1) - np.float32(b2) ** t))


def _bias_corrections(tx: LazyAdamTx, count: int):
    return bias_corrections(tx.b1, tx.b2, count)


def _decay_of(tx: LazyAdamTx, params: Params) -> Callable[[str], float]:
    mask = tx.decay_mask
    if callable(mask):
        mask = mask(params)
    return lambda path: tx.l2 if (tx.l2 > 0 and (mask is None or mask[path])) else 0.0


def _adam_math(tx: LazyAdamTx, p32, g32, m, v, bc1, bc2, decay):
    """(new param, new mu, new nu) in f32, in the operation order of
    optax.adam (m_hat / (sqrt(v_hat) + eps), eps_root = 0) with l2 added
    to the gradient before the moments. Every lane goes through here."""
    if decay:
        g32 = g32 + decay * p32
    mr = tx.b1 * m + (1.0 - tx.b1) * g32
    vr = tx.b2 * v + (1.0 - tx.b2) * g32 * g32
    upd = tx.lr * (mr / bc1) / (torch.sqrt(vr / bc2) + tx.eps)
    return p32 - upd, mr, vr


def _dense_leaf_step(tx, p, g, m, v, bc1, bc2, decay):
    new_p, m2, v2 = _adam_math(tx, p.float(), g.float(), m, v, bc1, bc2, decay)
    p.copy_(new_p.to(p.dtype))
    m.copy_(m2)
    v.copy_(v2)


def lazy_adam_step(tx: LazyAdamTx, params: Params, grads: Params, state: LazyAdamState,
                   rows_map: Dict[str, torch.Tensor]):
    """One Adam step from DENSE gradients: leaves in `rows_map` ({key: row
    ids}) update touched rows only; every other leaf runs the dense Adam
    math. In place; returns (params, state).

    Duplicate row ids are safe here and only here: the dense grad row
    already aggregates every occurrence, so each duplicate computes the
    identical value and the indexed assignment writes it idempotently.
    That is outside `scatter_rows`' unique-rows contract, so this lane
    keeps a plain indexed assignment."""
    state.count += 1
    bc1, bc2 = _bias_corrections(tx, state.count)
    decay_of = _decay_of(tx, params)
    for path, p in params.items():
        g, m, v = grads[path], state.mu[path], state.nu[path]
        if path in rows_map:
            rows = rows_map[path].long().ravel()
            new_p, mr, vr = _adam_math(tx, p[rows].float(), g[rows].float(), m[rows], v[rows],
                                       bc1, bc2, decay_of(path))
            p[rows] = new_p.to(p.dtype)
            m[rows] = mr
            v[rows] = vr
        else:
            _dense_leaf_step(tx, p, g, m, v, bc1, bc2, decay_of(path))
    return params, state


def unique_rows(ids: torch.Tensor, num_rows: int):
    """Static-size sorted unique for the sparse-grad lane.

    Returns (rows_sorted [R], scatter_rows [R]): rows_sorted is the sorted
    unique ids padded at the tail with `num_rows - 1` (>= every valid id,
    so the array stays sorted for searchsorted); scatter_rows equals
    rows_sorted on real slots and `num_rows` (out of range, dropped by
    `scatter_rows`) on pad slots, so each touched row is written exactly
    once. One sort + first-occurrence compaction; no host sync."""
    ids = ids.long().ravel()
    out_size = ids.shape[0]
    s = ids.sort().values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    slot = first.long().cumsum(0) - 1
    target = torch.where(first, slot, torch.full_like(slot, out_size))  # losers -> spare slot
    rows = torch.full((out_size + 1,), num_rows - 1, dtype=torch.long, device=ids.device)
    scatter = torch.full((out_size + 1,), num_rows, dtype=torch.long, device=ids.device)
    rows[target] = s
    scatter[target] = s
    return rows[:out_size], scatter[:out_size]


def unique_rows_hashed(ids: torch.Tensor, num_rows: int):
    """Sort-free dedup for the sparse lane: write each occurrence's
    position into a dense [num_rows] map and let ONE writer win. Returns
    (rows [R], scatter_rows [R], pos_map [num_rows] int32):

      * rows[j] = the id if position j won its id's slot, else
        num_rows - 1 (a valid row for the vals gather; never written);
      * scatter_rows[j] = the id on winner slots, num_rows (dropped by
        `scatter_rows`) elsewhere -- each touched row written exactly once;
      * pos_map[id] = winning slot for touched ids, R (out of range for
        vals -> fallback) for untouched ids: the TableEmbed lookup map.

    `pos_map[ids] = iota` with duplicate ids is not deterministic on CUDA
    about WHICH writer wins, but each 4-byte store is whole, so after the
    write pos_map[id] holds exactly one of its positions: there is exactly
    one j with pos_map[ids[j]] == j per distinct id. Any single winner is a
    valid slot assignment (all occurrences of an id map to the one winner
    slot, its gradient accumulates there, loser slots get zero gradient
    and are dropped at commit). `torch.use_deterministic_algorithms` must
    stay off on this path: it would replace the write by a sort.
    `rows` is NOT sorted; every consumer uses pos_map."""
    ids = ids.long().ravel()
    R = ids.shape[0]
    iota = torch.arange(R, dtype=torch.int32, device=ids.device)
    pos_map = torch.full((num_rows,), R, dtype=torch.int32, device=ids.device)
    pos_map[ids] = iota
    win = pos_map[ids] == iota
    rows = torch.where(win, ids, torch.full_like(ids, num_rows - 1))
    scatter = torch.where(win, ids, torch.full_like(ids, num_rows))
    return rows, scatter, pos_map


def row_pos_map(rows_sorted: torch.Tensor, scatter: torch.Tensor, num_rows: int):
    """Dense id -> slot map for the sparse-lookup context from the sort
    lane's outputs: map[id] = its slot in rows_sorted, `out_size` (out of
    range for vals) for untouched ids."""
    out_size = rows_sorted.shape[0]
    pos = torch.full((num_rows + 1,), out_size, dtype=torch.int32, device=scatter.device)
    pos[scatter.long()] = torch.arange(out_size, dtype=torch.int32, device=scatter.device)
    return pos[:num_rows]


def sparse_rows_and_vals(params: Params, rows_map):
    """For each lazy table: unique-ify the touched ids and gather their
    current values (f32 compute even for bf16 storage). Returns
    (rows_info {key: (rows, scatter_rows, pos_map)}, vals {key: [R, D]})."""
    rows_info, vals = {}, {}
    for path, ids in rows_map.items():
        p = params[path]
        rows, scatter, pos_map = unique_rows_hashed(ids, p.shape[0])
        rows_info[path] = (rows, scatter, pos_map)
        vals[path] = p.detach()[rows].float()
    return rows_info, vals


def split_params(params: Params, lazy_paths):
    """(rest, frozen): the leaves autograd differentiates and the lazy
    tables it must not (their lookups resolve through the [R, D] row
    blocks of the sparse-lookup context instead)."""
    lazy = set(lazy_paths)
    return ({k: v for k, v in params.items() if k not in lazy},
            {k: v for k, v in params.items() if k in lazy})


def _rest_step(tx, params, state, g_rest, bc1, bc2, decay_of):
    for path, g in g_rest.items():
        _dense_leaf_step(tx, params[path], g, state.mu[path], state.nu[path], bc1, bc2,
                         decay_of(path))


def lazy_adam_sparse_step(tx: LazyAdamTx, params: Params, state: LazyAdamState,
                          rows_info, vals, g_vals, g_rest):
    """Adam step for the sparse-grad lane: lazy tables update from their
    [R, D] row gradients (`g_vals`, the gradient of the gathered rows --
    already aggregated across duplicate ids by the lookup's backward);
    every other leaf runs the dense Adam math on `g_rest`. The table is
    only touched by O(R) gathers and three `scatter_rows` commits (param,
    mu, nu). In place; returns (params, state)."""
    state.count += 1
    bc1, bc2 = _bias_corrections(tx, state.count)
    decay_of = _decay_of(tx, params)
    for path in rows_info:
        rows, scatter = rows_info[path][:2]
        p, m, v = params[path], state.mu[path], state.nu[path]
        new_p, mr, vr = _adam_math(tx, vals[path], g_vals[path].float(), m[rows], v[rows],
                                   bc1, bc2, decay_of(path))
        scatter = scatter.to(torch.int32)
        scatter_rows(p, scatter, new_p.to(p.dtype))
        scatter_rows(m, scatter, mr)
        scatter_rows(v, scatter, vr)
    _rest_step(tx, params, state, g_rest, bc1, bc2, decay_of)
    return params, state


def pack_lazy_leaves(params: Params, state: LazyAdamState, paths):
    """Epoch carry layout for the sparse-grad lane: concat [p | mu | nu] ->
    ONE [N, 3D] f32 leaf per lazy table (replacing the param leaf in the
    returned dict; mu/nu get 0-size placeholders), so every step does one
    row gather and one `scatter_rows` commit per table instead of three
    each. Packing happens around the epoch (pack before the step loop,
    unpack after), so checkpoints, eval and the external state layout
    never see the packed form. bf16 tables ride the epoch in f32 and round
    once at unpack (strictly MORE precise than rounding every step).
    Returns (params, state, dtypes) as NEW containers; the input tensors
    are not modified."""
    dtypes = {}
    params, mu, nu = dict(params), dict(state.mu), dict(state.nu)
    for path in paths:
        p = params[path]
        dtypes[path] = p.dtype
        params[path] = torch.cat([p.detach().float(), mu[path], nu[path]], dim=1)
        mu[path] = torch.zeros((0,), dtype=torch.float32, device=p.device)
        nu[path] = torch.zeros((0,), dtype=torch.float32, device=p.device)
    return params, LazyAdamState(state.count, mu, nu), dtypes


def unpack_lazy_leaves(params: Params, state: LazyAdamState, dtypes):
    """Inverse of pack_lazy_leaves (runs after the epoch's step loop)."""
    params, mu, nu = dict(params), dict(state.mu), dict(state.nu)
    for path, dt in dtypes.items():
        packed = params[path]
        d = packed.shape[1] // 3
        params[path] = packed[:, :d].to(dt).contiguous()
        mu[path] = packed[:, d:2 * d].contiguous()
        nu[path] = packed[:, 2 * d:].contiguous()
    return params, LazyAdamState(state.count, mu, nu)


def packed_rows_and_vals(params: Params, rows_map):
    """Packed-carry analogue of sparse_rows_and_vals: ONE [R, 3D] row
    gather per table serves the forward pass (param lanes) AND the
    optimizer (moment lanes). Returns (rows_info, gathered {key: [R, 3D]},
    vals {key: [R, D] param lanes, a view of gathered})."""
    rows_info, gathered, vals = {}, {}, {}
    for path, ids in rows_map.items():
        packed = params[path]
        rows, scatter, pos_map = unique_rows_hashed(ids, packed.shape[0])
        rows_info[path] = (rows, scatter, pos_map)
        g = packed[rows]
        gathered[path] = g
        vals[path] = g[:, : packed.shape[1] // 3]
    return rows_info, gathered, vals


def lazy_adam_sparse_step_packed(tx: LazyAdamTx, params: Params, state: LazyAdamState,
                                 rows_info, gathered, g_vals, g_rest):
    """lazy_adam_sparse_step on the packed [p | mu | nu] carry: the Adam
    math is the same function (bit-equal to the unpacked lane in f32), but
    each table commits with ONE [R, 3D] `scatter_rows` instead of three.
    In place; returns (params, state)."""
    state.count += 1
    bc1, bc2 = _bias_corrections(tx, state.count)
    decay_of = _decay_of(tx, params)
    for path in rows_info:
        scatter = rows_info[path][1]
        packed = params[path]
        d = packed.shape[1] // 3
        g = gathered[path]
        new_p, mr, vr = _adam_math(tx, g[:, :d], g_vals[path].float(), g[:, d:2 * d],
                                   g[:, 2 * d:], bc1, bc2, decay_of(path))
        scatter_rows(packed, scatter.to(torch.int32), torch.cat([new_p, mr, vr], dim=1))
    _rest_step(tx, params, state, g_rest, bc1, bc2, decay_of)
    return params, state


def resolve_lazy_rows(specs: dict, params: Params, feed) -> dict:
    """{key: feed-key tuple} -> {key: concatenated id tensor}, keeping only
    keys that exist in this model's parameters and feed keys present in
    this feed (models share base-class specs; both can vary)."""
    out = {}
    for path, feed_keys in specs.items():
        if path not in params:
            continue
        cols = [feed[k].reshape(-1) for k in feed_keys if k in feed]
        if cols:
            out[path] = torch.cat(cols) if len(cols) > 1 else cols[0]
    return out
