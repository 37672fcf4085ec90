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

The sparse lanes commit through `adam_commit`: one launch per table per
step of `rtt_adam_commit_kernel` (csrc/scatter_kernels.cu, the Adam row
update in the body of kernel B4's row walk) in either lane. Its plain
version is `_adam_math` followed by `cuda_scatter.scatter_rows_plain`.

The dense optimizer's Adam (runners/base.py::DenseOptimizer) steps each
tensor through `adam_dense`: one launch of `rtt_adam_dense_kernel`
(csrc/scatter_kernels.cu) reads p, g, m and v once and writes p, m and v
once, bit-equal to the eager sequence `adam_dense_plain`, which it runs on
CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from rechorus_tpu_torch.ops import _build
from rechorus_tpu_torch.ops.cuda_scatter import scatter_rows_plain

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
    `adam_commit`) on pad slots, so each touched row is written exactly
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
        `adam_commit`) elsewhere -- each touched row written exactly once;
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


def unique_rows_sorted(ids: torch.Tensor, num_rows: int):
    """`unique_rows_hashed`'s outputs from the sort lane: the same slot of
    an id on every device (a data-parallel step sums the slots' gradients
    over ranks, so their layout must agree)."""
    rows, scatter = unique_rows(ids, num_rows)
    return rows, scatter, row_pos_map(rows, scatter, num_rows)


def _dedup(ids, n_rows: int, sentinel: bool, deterministic: bool):
    """(rows, scatter, pos_map) of a table of n_rows rows. With `sentinel`
    the ids are a row-sharded table's local rows and n_rows stands for the
    other shards' ids: that id is dropped at commit (its write id n_rows is
    out of range) and its read row is clamped into the table."""
    fn = unique_rows_sorted if deterministic else unique_rows_hashed
    rows, scatter, pos_map = fn(ids, n_rows + 1 if sentinel else n_rows)
    if sentinel:
        rows = rows.clamp(max=n_rows - 1)
    return rows, scatter, pos_map


def sparse_rows_and_vals(params: Params, rows_map, sentinel=(), deterministic: bool = False):
    """For each lazy table: unique-ify the touched ids and gather their
    current values (f32 compute even for bf16 storage). Returns
    (rows_info {key: (rows, scatter_rows, pos_map)}, vals {key: [R, D]}).
    Keys in `sentinel` hold row-sharded local ids (`_dedup`);
    `deterministic` takes the sort lane."""
    rows_info, vals = {}, {}
    for path, ids in rows_map.items():
        p = params[path]
        rows, scatter, pos_map = _dedup(ids, p.shape[0], path in sentinel, deterministic)
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
    every other leaf runs the dense Adam math on `g_rest`. Each lazy table
    is touched only by one `adam_commit`, which reads the mu/nu rows and
    writes param, mu and nu. In place; returns (params, state)."""
    state.count += 1
    bc1, bc2 = _bias_corrections(tx, state.count)
    decay_of = _decay_of(tx, params)
    for path in rows_info:
        rows, scatter = rows_info[path][:2]
        adam_commit(tx, bc1, bc2, decay_of(path), params[path], g_vals[path], scatter,
                    vals=vals[path], rows=rows, mu=state.mu[path], nu=state.nu[path])
    _rest_step(tx, params, state, g_rest, bc1, bc2, decay_of)
    return params, state


def adam_commit_plain(tx: LazyAdamTx, bc1: float, bc2: float, decay: float,
                      table: torch.Tensor, g: torch.Tensor, scatter: torch.Tensor, *,
                      gathered=None, vals=None, rows=None, mu=None, nu=None) -> torch.Tensor:
    """`adam_commit` as PyTorch ops: `_adam_math` on the slots' rows, then
    `scatter_rows_plain` of the new rows (one [R, 3D] block packed, three
    [R, D] blocks otherwise). In place; returns `table`."""
    if gathered is not None:
        d = table.shape[1] // 3
        new_p, mr, vr = _adam_math(tx, gathered[:, :d], g, gathered[:, d:2 * d],
                                   gathered[:, 2 * d:], bc1, bc2, decay)
        return scatter_rows_plain(table, scatter, torch.cat([new_p, mr, vr], dim=1))
    new_p, mr, vr = _adam_math(tx, vals, g, mu[rows], nu[rows], bc1, bc2, decay)
    scatter_rows_plain(table, scatter, new_p.to(table.dtype))
    scatter_rows_plain(mu, scatter, mr)
    scatter_rows_plain(nu, scatter, vr)
    return table


def adam_commit(tx: LazyAdamTx, bc1: float, bc2: float, decay: float,
                table: torch.Tensor, g: torch.Tensor, scatter: torch.Tensor, *,
                gathered=None, vals=None, rows=None, mu=None, nu=None) -> torch.Tensor:
    """The lazy-Adam row commit of one table, IN PLACE; returns `table`.
    Slot i of the row gradient g [R, D] f32 updates row scatter[i] with
    `_adam_math` (bias corrections bc1/bc2, l2 `decay`, 0 for none); slots
    whose write id lies outside [0, N) are dropped and read nothing. Write
    ids of kept slots are unique. Ids are int64, all tensors contiguous on
    one device. Two layouts:

      * packed (`gathered` given): table [N, 3D] f32 = [p | mu | nu],
        gathered [R, 3D] f32 the slots' rows of it before the step;
      * three tables (`vals`, `rows`, `mu`, `nu` given): table p [N, D] f32
        or bf16, mu and nu [N, D] f32, vals [R, D] f32 the slots' p rows,
        rows [R] the read ids of mu and nu (equal to scatter on kept slots).

    One launch of `rtt_adam_commit_kernel` on CUDA tensors; the plain
    version on CPU ones."""
    name = "adam_commit"
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be 2-D, got {tuple(table.shape)}")
    N, W = table.shape
    R = scatter.shape[0]
    dev = table.device
    packed = gathered is not None
    if packed == (vals is not None or rows is not None or mu is not None or nu is not None):
        raise ValueError(f"{name}: give either `gathered` (packed) or vals, rows, mu and nu")
    if packed:
        if W % 3:
            raise ValueError(f"{name}: a packed table is [N, 3D], got {tuple(table.shape)}")
        D = W // 3
        _build.check_input(name, "table", table, torch.float32, (N, W), dev)
        _build.check_input(name, "gathered", gathered, torch.float32, (R, W), dev)
    else:
        if rows is None or vals is None or mu is None or nu is None:
            raise ValueError(f"{name}: the three-table form takes vals, rows, mu and nu")
        D = W
        if table.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: table has dtype {table.dtype}, the kernel takes "
                            "torch.float32 or torch.bfloat16")
        _build.check_input(name, "table", table, table.dtype, (N, D), dev)
        _build.check_input(name, "mu", mu, torch.float32, (N, D), dev)
        _build.check_input(name, "nu", nu, torch.float32, (N, D), dev)
        _build.check_input(name, "vals", vals, torch.float32, (R, D), dev)
        _build.check_input(name, "rows", rows, torch.int64, (R,), dev)
    _build.check_input(name, "g", g, torch.float32, (R, D), dev)
    _build.check_input(name, "scatter", scatter, torch.int64, (R,), dev)
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} has no gradient: call it under torch.no_grad()")
    if dev.type == "cpu":
        return adam_commit_plain(tx, bc1, bc2, decay, table, g, scatter, gathered=gathered,
                                 vals=vals, rows=rows, mu=mu, nu=nu)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not (R and N and D):
        return table
    # the step's Python scalars as _adam_math hands them to PyTorch, whose
    # division by a Python float multiplies by the reciprocal taken in double
    adam = (tx.b1, 1.0 - tx.b1, tx.b2, 1.0 - tx.b2, tx.lr, tx.eps, decay, bool(decay),
            1.0 / bc1, 1.0 / bc2)
    if packed:
        _build.launchers.rtt_adam_commit_packed(
            dev.index, table.data_ptr(), gathered.data_ptr(), g.data_ptr(), scatter.data_ptr(),
            N, R, D, *adam)
    else:
        _build.launchers.rtt_adam_commit_rows(
            dev.index, table.data_ptr(), int(table.dtype == torch.bfloat16), mu.data_ptr(),
            nu.data_ptr(), vals.data_ptr(), g.data_ptr(), rows.data_ptr(), scatter.data_ptr(),
            N, R, D, *adam)
    _ADAM_COMMIT.launches += 1
    return table


adam_commit.launches = 0
# the count lives on this function object, which its body names by this
# binding: a stand-in put under the module's name `adam_commit` that calls
# the kernel leaves the count here
_ADAM_COMMIT = adam_commit


def adam_dense_plain(tx, bc1: float, bc2: float, decay: float, p: torch.Tensor, g: torch.Tensor,
                     m: torch.Tensor, v: torch.Tensor, *, decoupled: bool = False,
                     scale=None) -> torch.Tensor:
    """`adam_dense` as eager PyTorch ops: DenseOptimizer.update's Adam
    sequence, rounding for rounding. In place; returns `p`."""
    if decay and not decoupled:
        g = g.add(p, alpha=decay)
    m.mul_(tx.b1).add_(g, alpha=1.0 - tx.b1)
    v.mul_(tx.b2).addcmul_(g, g, value=1.0 - tx.b2)
    step = (m / bc1).div_((v / bc2).sqrt_().add_(tx.eps))
    if decoupled and decay:
        step.add_(p, alpha=decay)
    if scale is None:
        p.sub_(step, alpha=tx.lr)
    else:
        p.sub_(step * tx.lr * scale)
    return p


def adam_dense(tx, bc1: float, bc2: float, decay: float, p: torch.Tensor, g: torch.Tensor,
               m: torch.Tensor, v: torch.Tensor, *, decoupled: bool = False,
               scale=None) -> torch.Tensor:
    """One dense Adam step of one tensor, IN PLACE; returns `p`. `tx`
    gives b1, b2, lr and eps; bc1 and bc2 are the bias corrections; `decay`
    (0 for none) is l2 added to the gradient, or with `decoupled` AdamW's
    term added to the step; `scale` (None for none) multiplies the step's
    lr. p, g, m and v are contiguous f32 tensors of one shape on one
    device. One launch of `rtt_adam_dense_kernel` on CUDA tensors; the
    plain version on CPU ones."""
    name = "adam_dense"
    dev, shape = p.device, p.shape
    for arg, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _build.check_input(name, arg, t, torch.float32, shape, dev)
    if p.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} has no gradient: call it under torch.no_grad()")
    if dev.type == "cpu":
        return adam_dense_plain(tx, bc1, bc2, decay, p, g, m, v, decoupled=decoupled, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not p.numel():
        return p
    l2, wd = (0.0, decay) if decoupled else (decay, 0.0)
    # Python scalars as PyTorch hands them to its kernels: float32, with
    # the divisions by bc1 and bc2 as products with their reciprocals
    _build.launchers.rtt_adam_dense(
        dev.index, p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        tx.b1, 1.0 - tx.b1, tx.b2, 1.0 - tx.b2, tx.lr, tx.eps, 1.0 / bc1, 1.0 / bc2,
        l2, wd, 1.0 if scale is None else scale, scale is not None)
    _ADAM_DENSE.launches += 1
    return p


adam_dense.launches = 0
_ADAM_DENSE = adam_dense   # as _ADAM_COMMIT


def pack_lazy_leaves(params: Params, state: LazyAdamState, paths):
    """Epoch carry layout for the sparse-grad lane: concat [p | mu | nu] ->
    ONE [N, 3D] f32 leaf per lazy table (replacing the param leaf in the
    returned dict; mu/nu get 0-size placeholders), so every step gathers
    each touched row once, [p | mu | nu] together, for the forward pass and
    the commit. Packing happens around the epoch (pack before the step loop,
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


def packed_rows_and_vals(params: Params, rows_map, sentinel=(), deterministic: bool = False):
    """Packed-carry analogue of sparse_rows_and_vals: ONE [R, 3D] row
    gather per table serves the forward pass (param lanes) AND the
    optimizer (moment lanes). Returns (rows_info, gathered {key: [R, 3D]},
    vals {key: [R, D] param lanes, a view of gathered})."""
    rows_info, gathered, vals = {}, {}, {}
    for path, ids in rows_map.items():
        packed = params[path]
        rows, scatter, pos_map = _dedup(ids, packed.shape[0], path in sentinel, deterministic)
        rows_info[path] = (rows, scatter, pos_map)
        g = packed[rows]
        gathered[path] = g
        vals[path] = g[:, : packed.shape[1] // 3]
    return rows_info, gathered, vals


def lazy_adam_sparse_step_packed(tx: LazyAdamTx, params: Params, state: LazyAdamState,
                                 rows_info, gathered, g_vals, g_rest):
    """lazy_adam_sparse_step on the packed [p | mu | nu] carry: the Adam
    math is the same function (bit-equal to the unpacked lane in f32), and
    each table commits its [R, 3D] rows with one `adam_commit`. In place;
    returns (params, state)."""
    state.count += 1
    bc1, bc2 = _bias_corrections(tx, state.count)
    decay_of = _decay_of(tx, params)
    for path in rows_info:
        adam_commit(tx, bc1, bc2, decay_of(path), params[path], g_vals[path], rows_info[path][1],
                    gathered=gathered[path])
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
