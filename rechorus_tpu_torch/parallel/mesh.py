"""Device mesh + sharding rules (port of rechorus_tpu/parallel/mesh.py).

The JAX package places arrays on a ('data', 'model') `Mesh` and lets
GSPMD insert the collectives. Here each mesh position is one process
(parallel/distributed.py) holding one device, and the collectives are
explicit:

  * rank r sits at data index r // mp and model index r % mp (the JAX
    package's `reshape(dp, mp)` of its devices); the 'data' group joins
    the ranks of one model index, the 'model' group those of one data
    index;
  * embedding tables (the memory-dominant state in recsys) row-shard over
    'model' by the JAX package's rule (`param_spec`): rank r keeps rows
    [r_m * N/m, (r_m + 1) * N/m) of each, and its optimizer moments
    beside them. A lookup is a masked local gather plus a sum over
    'model' (`take_rows`); a read of the whole table gathers it
    (`full_table`);
  * everything else is replicated; each step's batch is split over 'data'
    and gradients are averaged over 'data' (runners/base.py).

Row-count divisibility: tables are (n + 1)-row, which rarely divides the
'model' axis. `set_table_row_pad(m)`, called before the model is built,
makes every table built through ops.layers.embed round its rows up to a
multiple of m; dead rows are never gathered. `param_spec` still checks
divisibility and replicates, with a warning, any table that slipped
through (raw parameters with hand-set shapes).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import torch
import torch.distributed as dist

# Embedding tables smaller than this stay replicated (sharding overhead
# would dominate); row-sharding kicks in for production-size catalogs.
MIN_ROWS_TO_SHARD = 1024

# Row-count quantum for tables built via ops.layers.embed; set to the
# mesh 'model'-axis size before the model is built so row-sharding divides.
_TABLE_ROW_PAD = 1


def set_table_row_pad(m: int) -> None:
    """Round embedding-table row counts up to a multiple of m (>= 1).
    Must be called BEFORE the model is built."""
    global _TABLE_ROW_PAD
    _TABLE_ROW_PAD = max(1, int(m))


def get_table_row_pad() -> int:
    return _TABLE_ROW_PAD


def pad_rows(num: int) -> int:
    """Logical row count -> physical row count under the current pad."""
    m = _TABLE_ROW_PAD
    return ((num + m - 1) // m) * m


# ------------------------------------------------------------------ mesh
@dataclasses.dataclass
class Mesh:
    """This rank's view of the ('data', 'model') mesh."""
    dp: int
    mp: int
    data_index: int
    model_index: int
    data_group: object      # the ranks of this model index, over 'data'
    model_group: object     # the ranks of this data index, over 'model'
    device_mesh: object     # torch DeviceMesh (the DTensors of a sharded checkpoint)


_MESHES: Dict[tuple, Mesh] = {}
_CPU_GROUP = []


def make_mesh(n_devices: int, model_parallel: int, device: torch.device) -> Mesh:
    """The ('data', 'model') mesh of the running process group, which must
    hold exactly n_devices ranks (`main` starts them). Built once per shape
    and process group: building a group is a collective of every rank."""
    mp = max(1, int(model_parallel))
    dp = n_devices // mp
    if dp * mp != n_devices:
        raise ValueError(f"mesh: {n_devices} devices do not divide by model axis {mp}")
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != n_devices:
        have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        raise ValueError(f"mesh {dp}x{mp} needs a process group of {n_devices} ranks, have "
                         f"{have}: start the run through rechorus_tpu_torch.main "
                         "(it starts the ranks), or one CLI per host with --dist_coordinator")
    key = (dp, mp, id(dist.group.WORLD))
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh(device.type, (dp, mp), mesh_dim_names=("data", "model"))
        r = dist.get_rank()
        _MESHES[key] = Mesh(dp, mp, r // mp, r % mp, dm.get_group("data"),
                            dm.get_group("model"), dm)
    return _MESHES[key]


def reset_meshes() -> None:
    """Forget the cached meshes (after destroy_process_group)."""
    _MESHES.clear()
    _CPU_GROUP.clear()


def cpu_group():
    """A gloo group over every rank for CPU-side coordination (the sharded
    checkpoint's metadata), or None when the default group is gloo."""
    if dist.get_backend() == "gloo":
        return None
    if not _CPU_GROUP:
        _CPU_GROUP.append(dist.new_group(backend="gloo"))
    return _CPU_GROUP[0]


# ---------------------------------------------------------- collectives
class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over `group`. Backward: the identity -- the
    upstream gradient is already the same on every rank of the group (they
    all compute the same thing from the summed value), and a differentiable
    all_reduce would multiply it by the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """Forward: the row blocks of `group` concatenated in rank order.
    Backward: this rank's block of the gradient (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, index, parts):
        out = [torch.empty_like(x) for _ in range(parts)]
        dist.all_gather(out, x.contiguous(), group=group)
        ctx.lo, ctx.n = index * x.shape[0], x.shape[0]
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo: ctx.lo + ctx.n], None, None, None


def sum_over(x: torch.Tensor, group, size: int) -> torch.Tensor:
    return x if size == 1 else _SumOverGroup.apply(x, group)


def gather_rows_over(x: torch.Tensor, group, index: int, size: int) -> torch.Tensor:
    return x if size == 1 else _GatherRows.apply(x, group, index, size)


def all_gather_cat(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """Equal-shaped blocks of `group` concatenated along `dim` in rank
    order (no gradient)."""
    if size == 1:
        return x
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.cat(out, dim=dim)


def reduce_over_data(tensors, mesh: Optional[Mesh], mean: bool = True) -> None:
    """Sum gradients over 'data', IN PLACE, as one flat all_reduce, and
    with `mean` divide them by the axis size: the ranks' gradients of a
    loss that averages its rows (`mean`) or sums them."""
    tensors = [t for t in tensors if t.numel()]
    if mesh is None or mesh.dp == 1 or not tensors:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat, group=mesh.data_group)
        if mean:
            flat.div_(mesh.dp)
        for t, s in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(s)


# ----------------------------------------------------- row-sharded tables
@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """A table's row block on this rank: global rows [lo, lo + n_local) of
    n_global, one of `parts` blocks over `group` ('model')."""
    lo: int
    n_local: int
    n_global: int
    index: int
    parts: int
    group: object


def shard_of(t) -> Optional[ShardInfo]:
    return getattr(t, "rtt_shard", None)


def masked_local_rows(gather, ids: torch.Tensor, lo: int, n_local: int) -> torch.Tensor:
    """A row-sharded gather's local part: `gather(local ids)` on a block
    holding global rows [lo, lo + n_local), with the rows of `ids` outside
    the block zeroed. Summed over the block's group, it is the gather of
    the whole array."""
    loc = ids.long() - lo
    inside = (loc >= 0) & (loc < n_local)
    rows = gather(loc.clamp(0, n_local - 1))
    mask = inside.reshape(inside.shape + (1,) * (rows.dim() - inside.dim()))
    return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` for a whole or a row-sharded table: on a shard, the
    masked local gather summed over 'model'."""
    info = shard_of(table)
    if info is None:
        return table[ids]
    rows = masked_local_rows(lambda loc: table[loc], ids, info.lo, info.n_local)
    return sum_over(rows, info.group, info.parts)


def full_table(table: torch.Tensor) -> torch.Tensor:
    """The whole [N, ...] table of a whole or row-sharded one (gathered
    over 'model'; its gradient is this rank's block)."""
    info = shard_of(table)
    if info is None:
        return table
    return gather_rows_over(table, info.group, info.index, info.parts)


def param_spec(path: tuple, shape, model_size: int = 1) -> Optional[str]:
    """Sharding rule of one flax leaf path: 2-D 'embedding' tables of at
    least MIN_ROWS_TO_SHARD rows row-shard over 'model' ("model"); tables
    whose rows do not divide the axis replicate with a warning (None)."""
    names = [str(p) for p in path]
    is_table = any("embedding" in n.lower() for n in names) and len(shape) == 2
    if is_table and shape[0] >= MIN_ROWS_TO_SHARD:
        if model_size > 1 and shape[0] % model_size != 0:
            logging.warning(
                "Table %s rows=%d not divisible by model axis %d; replicating "
                "(call set_table_row_pad(%d) before model init to shard it)",
                "/".join(names), shape[0], model_size, model_size)
            return None
        return "model"
    return None


def sharded_keys(model, model_size: int) -> list:
    """The parameter names (state_dict keys) of `model` that row-shard on
    a model axis of `model_size`: the JAX rule applied to each parameter's
    flax path (weights.flax_leaf_path)."""
    from rechorus_tpu_torch import weights

    name = model.registered_name
    out = []
    for key, p in model.named_parameters():
        path = weights.flax_leaf_path(name, key, p)
        if path is not None and param_spec(path, tuple(p.shape), model_size) == "model":
            out.append(key)
    return out


def shard_model(model, mesh: Mesh) -> list:
    """Keep only this rank's row block of every table that row-shards
    (`sharded_keys`), IN PLACE, and mark it with its ShardInfo. Returns the
    sharded keys. Call it before the optimizer state is built, so the
    moments are built from the blocks."""
    keys = sharded_keys(model, mesh.mp) if mesh.mp > 1 else []
    own = dict(model.named_parameters())
    for key in keys:
        p = own[key]
        n = p.shape[0]
        n_local = n // mesh.mp
        lo = mesh.model_index * n_local
        with torch.no_grad():
            p.data = p.data[lo: lo + n_local].clone()
        p.rtt_shard = ShardInfo(lo, n_local, n, mesh.model_index, mesh.mp, mesh.model_group)
    if keys:
        logging.info("row-sharded over 'model' (%d): %s", mesh.mp, ", ".join(keys))
    return keys


def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every row-sharded table gathered whole (a
    collective of the 'model' group)."""
    sd = model.state_dict()
    with torch.no_grad():
        for key, p in model.named_parameters():
            if shard_of(p) is not None:
                sd[key] = full_table(p).detach()
    return sd


def live_rows(model) -> Dict[str, int]:
    """{state_dict key: live row count} of the padded tables of `model`:
    those `ops.layers.embed` built and the padded copies a model keeps
    (BUIR's targets), each module naming its own in `live_rows`."""
    out = {}
    for name, mod in model.named_modules():
        for key, n in getattr(mod, "live_rows", {}).items():
            out[f"{name}.{key}" if name else key] = n
    return out


def load_full_state_dict(model, state_dict) -> None:
    """Load whole tensors into a model whose tables may be row-sharded:
    each sharded table takes its block. A padded table written under
    another row pad -- the tensor holds the live rows and a dead tail
    shorter than the current row pad -- takes the live rows; its own dead
    tail rows keep their values. Any other shape mismatch raises (a
    catalog of another size among them, unless it differs by less than
    the pad, which no row count can tell from padding)."""
    own = model.state_dict(keep_vars=True)
    live = live_rows(model)
    pad = get_table_row_pad()
    local = {}
    for key, v in state_dict.items():
        cur = own.get(key)
        if cur is None:
            local[key] = v
            continue
        info = shard_of(cur)
        lo, n = (info.lo, info.n_local) if info is not None else (0, cur.shape[0] if cur.dim() else 1)
        n_global = info.n_global if info is not None else n
        if v.dim() == cur.dim() >= 1 and v.shape[1:] == cur.shape[1:] and v.shape[0] != n_global:
            if key not in live or not live[key] <= v.shape[0] < live[key] + pad:
                raise RuntimeError(
                    f"checkpoint tensor {key!r} has {v.shape[0]} rows, the model {n_global}"
                    + (f" ({live[key]} live under a row pad of {pad})" if key in live else ""))
            block = cur.detach().clone()
            hi = min(lo + n, live[key])
            if hi > lo:
                block[: hi - lo] = v[lo: hi].to(device=block.device, dtype=block.dtype)
            v = block
        elif info is not None:
            v = v[lo: lo + n]
        local[key] = v
    model.load_state_dict(local)


# ------------------------------------------------------------ batch rows
class ShardedRows:
    """A corpus array row-sharded over 'data' (`--shard_input_mb`): this
    rank keeps the block [lo, lo + size) of the array zero-padded to
    `parts * size` rows. Indexing by global row ids -- a tensor, or a
    tuple whose first element is one -- is the masked local gather of
    those rows plus a sum over 'data', which every rank of the group calls
    with the same ids: GSPMD's lowering of a gather from a sharded
    operand."""

    def __init__(self, block: torch.Tensor, n: int, lo: int, mesh: Mesh):
        self.block, self.n, self.lo, self.mesh = block, n, lo, mesh
        self.shape = torch.Size((n,) + tuple(block.shape[1:]))
        self.dtype, self.device = block.dtype, block.device

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        rest = ()
        if isinstance(index, tuple):
            index, rest = index[0], index[1:]
        if not torch.is_tensor(index):
            raise TypeError("ShardedRows takes tensor row ids")

        def gather(loc):
            got = self.block[(loc,) + rest]
            return got.to(torch.int32) if got.dtype == torch.bool else got

        got = masked_local_rows(gather, index, self.lo, self.block.shape[0])
        dist.all_reduce(got, group=self.mesh.data_group)
        return got.to(self.dtype)


def shard_input(x: torch.Tensor, mesh: Mesh) -> ShardedRows:
    """Row-shard a corpus array over 'data' (zero-padded to divide)."""
    lo, hi = data_block(x.shape[0], mesh)
    return sharded_input_from_block(x[lo: hi], x.shape[0], mesh)


def data_block(n: int, mesh: Mesh) -> tuple:
    """(lo, hi) of this rank's 'data' block of n rows padded to divide."""
    size = -(-n // mesh.dp)
    return mesh.data_index * size, (mesh.data_index + 1) * size


def sharded_input_from_block(block: torch.Tensor, n: int, mesh: Mesh) -> ShardedRows:
    """A ShardedRows from this rank's already-built block (host-sharded
    loading): `block` holds rows [data_index * size, ... + size)."""
    lo, hi = data_block(n, mesh)
    if block.shape[0] < hi - lo:
        block = torch.cat([block, block.new_zeros((hi - lo - block.shape[0],) + tuple(block.shape[1:]))])
    return ShardedRows(block.contiguous(), n, lo, mesh)

