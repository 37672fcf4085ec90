"""Shared torch blocks (port of rechorus_tpu/ops/layers.py:38-444: `dense`
and its init scheme, `TableEmbed`, `embed`, the table dtype and the
sparse-lookup context, dropout, `MLPBlock` with flax's `BatchNorm` and
`LayerNorm`, `Dice`, `apply_activation`, `AttLayer`, `MaskedGRU`,
`AttentionalGRU`, `BiLSTM`, `MultiHeadAttention`,
`MultiHeadTargetAttention` and `TransformerLayer`).

Init convention of the reference BaseModel.init_weights
(src/models/BaseModel.py:29-35): N(0, 0.01) for embedding tables and
dense kernels and biases. Every parameter is drawn by
`BaseModel.init_weights` from one generator through `param_init` below;
a module names its parameters' initialisers in `PARAM_INITS` (the flax
initialisers of the JAX package's layer: LayerNorm ones and zeros, the
GRU and LSTM cells' lecun-normal, orthogonal and zeros).

Blocks that act differently in training take `training` and the step's
`torch.Generator` explicitly, as the flax modules take `training` and a
'dropout' rng; `model.train()` / `model.eval()` change nothing here.
"""
from __future__ import annotations

import math
import warnings
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rechorus_tpu_torch.parallel.mesh import (full_table, masked_local_rows, pad_rows, shard_of,
                                             sum_over)

INIT_STD = 0.01


# ------------------------------------------------------------------ inits
def _normal(shape, gen):
    return torch.randn(shape, generator=gen, device=gen.device) * INIT_STD


def _zeros(shape, gen):
    return torch.zeros(shape, device=gen.device)


def _ones(shape, gen):
    return torch.ones(shape, device=gen.device)


def _glorot_uniform(shape, gen):
    """flax glorot_uniform of a [out, in] weight (symmetric in the fans)."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0) * limit


def _truncated_normal(shape, gen, variance: float):
    """flax's variance-scaling truncated normal: a normal truncated at two
    standard deviations, std sqrt(variance) / 0.8796 (the truncation's std
    correction), drawn by inverting the normal CDF."""
    std = math.sqrt(variance) / 0.87962566103423978
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo
    return (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-2.0, 2.0) * std


def _lecun_normal(shape, gen):
    """flax lecun_normal of a [out, in] weight: variance 1 / fan_in."""
    return _truncated_normal(shape, gen, 1.0 / shape[1])


def _glorot_normal(shape, gen):
    """flax glorot_normal (xavier_normal) of a 2-D weight, symmetric in the
    fans: variance 2 / (fan_in + fan_out), truncated at two std."""
    return _truncated_normal(shape, gen, 2.0 / (shape[0] + shape[1]))


def _unit_normal(shape, gen):
    """flax normal(1.0): N(0, 1)."""
    return torch.randn(shape, generator=gen, device=gen.device)


def _xavier_normal_heads(shape, gen):
    """flax xavier_normal of an [H, X, Y] weight: fan_in H * X, fan_out
    H * Y (the leading axis is the receptive field), truncated at two std."""
    h, x, y = shape
    return _truncated_normal(shape, gen, 2.0 / (h * x + h * y))


def _uniform(scale: float):
    """U(-scale, scale) (torch's GRU default at scale 1 / sqrt(hidden))."""
    def init(shape, gen):
        return (torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0) * scale
    return init


def _constant(value: float):
    def init(shape, gen):
        return torch.full(shape, value, device=gen.device)
    return init


def _orthogonal(shape, gen):
    """flax orthogonal of a square [H, H] weight: Q of the QR of a normal
    draw, with the signs of R's diagonal folded in (Haar-distributed)."""
    a = torch.randn(shape, generator=gen, device=gen.device)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def param_init(module: nn.Module, name: str):
    """Initialiser `(shape, gen) -> tensor` of `module`'s own parameter
    `name`: its `PARAM_INITS` entry, else N(0, 0.01)."""
    return getattr(module, "PARAM_INITS", {}).get(name, _normal)


# process-global Dense init scheme (--dense_init), read when a layer is
# built: 'reference' is N(0, 0.01) for kernel and bias (reference
# BaseModel.py:29-35); 'glorot' is glorot-uniform kernels with zero
# biases, the JAX package's documented deviation (rechorus_tpu/ops/
# layers.py:17-28) for deep multiplicative chains.
_DENSE_INIT = "reference"


def set_dense_init(mode: str) -> None:
    global _DENSE_INIT
    if mode not in ("reference", "glorot"):
        raise ValueError(f"--dense_init must be 'reference' or 'glorot', got {mode!r}")
    _DENSE_INIT = mode


class Dense(nn.Module):
    """flax `nn.Dense` in torch's layout (JAX `ops.layers.dense`): `weight`
    [out, in] (the flax kernel transposed), optional `bias` [out]."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 kernel_init=None, bias_init=None):
        """`kernel_init` / `bias_init` fix the initialisers; by default
        they follow the --dense_init scheme in force when the layer is
        built (`set_dense_init`). The parameters are left unset until
        `BaseModel.init_weights` draws them."""
        super().__init__()
        glorot = _DENSE_INIT == "glorot"
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.PARAM_INITS = {"weight": kernel_init or (_glorot_uniform if glorot else _normal),
                            "bias": bias_init or (_zeros if glorot else _normal)}

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """torch LayerNorm (eps 1e-5, as in the JAX package's layers) whose
    `weight` / `bias` start at ones / zeros under `init_weights`."""

    PARAM_INITS = {"weight": _ones, "bias": _zeros}

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)


def dropout(x: torch.Tensor, rate: float, training: bool, gen: Optional[torch.Generator]):
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the identity at rate 0 or out of
    training. The mask is drawn from `gen` (same seed, same mask)."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if _BATCH_SLICE is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    else:
        # a data-parallel step: draw the global batch's mask, keep our rows
        parts, index = _BATCH_SLICE
        b = x.shape[0]
        keep = torch.rand((b * parts,) + tuple(x.shape[1:]), generator=gen,
                          device=x.device)[index * b: (index + 1) * b] < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


# the data-parallel step's slice of the global batch, (parts, index), or
# None: while set, dropout draws its mask at the global batch's shape and
# keeps rows [index * b, (index + 1) * b), so a mesh run draws the masks a
# one-process run draws
_BATCH_SLICE = None


@contextmanager
def batch_slice(parts: int, index: int):
    global _BATCH_SLICE
    prev, _BATCH_SLICE = _BATCH_SLICE, ((parts, index) if parts > 1 else None)
    try:
        yield
    finally:
        _BATCH_SLICE = prev


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=eps)` over the last axis of
    an input of any rank, which `torch.nn.BatchNorm1d` is not: it reduces
    over every other axis (B and the candidate axis C of a [B, C, d]
    input), the variance is flax's fast one, max(0, E[x^2] - E[x]^2), and
    the running variance moves by that biased batch variance. In training
    the batch statistics normalise and the running ones move
    (r = momentum * r + (1 - momentum) * batch); otherwise the running
    ones normalise. `weight` / `bias` are flax's `scale` / `bias`, the
    buffers `running_mean` / `running_var` its `batch_stats` `mean` /
    `var`: they are part of the `state_dict`, so the best epoch's
    checkpoint carries them."""

    PARAM_INITS = {"weight": _ones, "bias": _zeros}

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """The JAX package's activation by name (flax's gelu is the tanh one)."""
    name_l = name.lower()
    if name_l == "relu":
        return torch.relu(x)
    if name_l == "sigmoid":
        return torch.sigmoid(x)
    if name_l == "tanh":
        return torch.tanh(x)
    if name_l == "gelu":
        return F.gelu(x, approximate="tanh")
    if name_l == "softplus":
        return F.softplus(x)
    if name_l in ("none", "linear", "identity"):
        return x
    raise ValueError(f"Unknown activation: {name}")


class Dice(nn.Module):
    """The DIN paper's adaptive activation (reference layers.py:246-285; JAX
    `Dice`): p * x + (1 - p) * alpha * x with p = sigmoid(bn(x)), `bn` the
    flax-faithful BatchNorm above at eps 1e-8 and momentum 0.9 (batch
    statistics in training, its running buffers otherwise), `alpha` [d]
    starting at zero."""

    PARAM_INITS = {"alpha": _zeros}

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim))
        self.bn = BatchNorm(dim, momentum=0.9, eps=1e-8)

    def forward(self, x, training: bool = False):
        p = torch.sigmoid(self.bn(x, training))
        return p * x + (1.0 - p) * self.alpha * x


class MLPBlock(nn.Module):
    """Configurable MLP tower (reference src/utils/layers.py:201-243; JAX
    `MLPBlock`): per hidden layer `dense_i`, then `bn_i` (flax BatchNorm,
    above) or `ln_i` when `norm` asks for one, the activation (`dice_i`
    for Dice), and dropout when `dropout_rate` > 0; a linear `head` when
    `output_dim` is set. `hidden_activations` is one name or one per
    layer."""

    def __init__(self, in_dim: int, hidden_units, hidden_activations="ReLU",
                 output_dim: Optional[int] = None, dropout_rate: float = 0.0,
                 use_bias: bool = True, norm: Optional[str] = None):
        super().__init__()
        acts = hidden_activations
        self.acts = [acts] * len(hidden_units) if isinstance(acts, str) else list(acts)
        self.dropout_rate, self.norm = dropout_rate, norm
        self.n_hidden = len(hidden_units)
        d = in_dim
        for i, h in enumerate(hidden_units):
            self.add_module(f"dense_{i}", Dense(d, h, use_bias))
            if norm == "batch_norm":
                self.add_module(f"bn_{i}", BatchNorm(h))
            elif norm == "layer_norm":
                self.add_module(f"ln_{i}", LayerNorm(h))
            if self.acts[i].lower() == "dice":
                self.add_module(f"dice_{i}", Dice(h))
            d = h
        self.head = Dense(d, output_dim, use_bias) if output_dim is not None else None
        self.out_dim = output_dim if output_dim is not None else d

    def forward(self, x, training: bool = False, gen=None):
        for i in range(self.n_hidden):
            x = getattr(self, f"dense_{i}")(x)
            if self.norm == "batch_norm":
                x = getattr(self, f"bn_{i}")(x, training)
            elif self.norm == "layer_norm":
                x = getattr(self, f"ln_{i}")(x)
            if self.acts[i].lower() == "dice":
                x = getattr(self, f"dice_{i}")(x, training)
            else:
                x = apply_activation(x, self.acts[i])
            if self.dropout_rate > 0:
                x = dropout(x, self.dropout_rate, training, gen)
        return self.head(x) if self.head is not None else x


class AttLayer(nn.Module):
    """Attention weights over the second-to-last axis (reference
    layers.py:65-90, RecBole-derived): softmax(sum(relu(w x) * h))."""

    PARAM_INITS = {"h": _unit_normal}

    def __init__(self, in_dim: int, att_dim: int):
        super().__init__()
        self.w = Dense(in_dim, att_dim, use_bias=False)
        self.h = nn.Parameter(torch.empty(att_dim))

    def forward(self, x):
        return torch.softmax((torch.relu(self.w(x)) * self.h).sum(-1), dim=-1)


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
        info = shard_of(table)
        if info is None:
            return self._lookup(inputs, table, entry).to(out_dtype)
        # row-sharded over 'model': this shard's rows by local id, zeros for
        # the other shards' ids, summed over the group
        out = masked_local_rows(lambda loc: self._lookup(loc, table, entry).to(out_dtype),
                                inputs, info.lo, info.n_local)
        return sum_over(out, info.group, info.parts)

    @staticmethod
    def _lookup(inputs, table, entry):
        if entry is None:
            return F.embedding(inputs, table)
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
        return torch.where(hit[..., None], F.embedding(pos, vals), fallback.to(vals.dtype))

    def full(self) -> torch.Tensor:
        """The whole [N, D] table (gathered over 'model' when row-sharded;
        the gradient of the gathered table is this rank's block). Every
        read of a whole table goes through here or `parallel.mesh.full_table`."""
        return full_table(self.weight)


def embed(num: int, dim: int, init=None) -> TableEmbed:
    """[pad_rows(num), dim] embedding table (num rows rounded up to the
    mesh's row pad, parallel/mesh.py; the dead tail rows are never
    gathered), N(0, 0.01) init from torch's global RNG,
    stored in the dtype of `set_table_dtype` (f32 unless --bf16_emb); `init`
    names the initialiser `BaseModel.init_weights` draws it from (default
    N(0, 0.01)). Every model-level table gather should go through this: a
    raw `weight[ids]` bypasses the bf16 storage cast AND the sparse-lookup
    context."""
    table = TableEmbed(pad_rows(num), dim, dtype=_TABLE_DTYPE)
    table.live_rows = {"weight": num}       # parallel.mesh.load_full_state_dict
    if init is not None:
        table.PARAM_INITS = {"weight": init}
    return table


# ------------------------------------------------------- sequence blocks
class GRUCell(nn.Module):
    """flax `nn.GRUCell`'s parameters in its layout: input projections
    `ir`, `iz`, `in` with biases, recurrent `hr`, `hz` without and `hn`
    with one (torch's `nn.GRU` would carry two more bias vectors the JAX
    model lacks, free to train away from it). Initialisers as flax's:
    lecun-normal input kernels, orthogonal recurrent kernels, zero biases.

      r = sigmoid(ir(x) + hr(h)); z = sigmoid(iz(x) + hz(h))
      n = tanh(in(x) + r * hn(h)); h' = (1 - z) * n + z * h
    """

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(in_features, hidden, True, _lecun_normal, _zeros))
        for name in ("hr", "hz", "hn"):
            self.add_module(name, Dense(hidden, hidden, name == "hn", _orthogonal, _zeros))

    def stacked(self):
        """[w_ih, w_hh, b_ih, b_hh] in torch's (r, z, n) gate order, with
        the hidden biases of r and z held at zero (not parameters): the
        cell's equations in the form PyTorch's GRU kernels take."""
        gi = [getattr(self, n) for n in ("ir", "iz", "in")]
        hn_bias = self.hn.bias
        return [torch.cat([m.weight for m in gi]),
                torch.cat([self.hr.weight, self.hz.weight, self.hn.weight]),
                torch.cat([m.bias for m in gi]),
                torch.cat([hn_bias.new_zeros(2 * self.hidden), hn_bias])]


class MaskedGRU(nn.Module):
    """GRU over left-aligned padded sequences, as the JAX `MaskedGRU`
    computes it (flax `nn.RNN(GRUCell)` with `seq_lengths`): the cell runs
    over all L steps, and the final state is the carry at step lengths - 1
    (at L - 1 for a row of length 0, as flax indexes). Returns (outputs
    [B, L, H], final [B, H]). The outputs at t >= lengths are the cell
    continued over the pad slots' inputs, as in flax (the JAX docstring's
    "carry the last valid state" does not hold there): mask them before
    use. All L steps run as one call of PyTorch's GRU (cuDNN on the card),
    forward and backward, instead of a Python loop of small ops."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.cell = GRUCell(in_features, hidden)

    def forward(self, seq, lengths):
        B, L, _ = seq.shape
        h0 = seq.new_zeros(1, B, self.cell.hidden)
        # (input, hx, params, has_biases, num_layers, dropout, train,
        # bidirectional, batch_first); cuDNN keeps what backward needs only
        # with train=True. The stacked weights are built per call, so cuDNN
        # copies them into its flat buffer (a few hundred KB) and says so
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            outputs, _ = torch._VF.gru(seq.contiguous(), h0, self.cell.stacked(), True, 1, 0.0,
                                       torch.is_grad_enabled(), False, True)
        last = torch.remainder(lengths - 1, L)
        return outputs, outputs.gather(1, last[:, None, None].expand(B, 1, outputs.shape[2]))[:, 0]


class AttentionalGRU(nn.Module):
    """GRU whose update takes an attention score per step (port of
    rechorus_tpu/ops/layers.py:256-317; reference DIEN.py:287-369's
    DynamicGRU / AGRUCell / AUGRUCell over packed sequences). Parameters in
    the JAX layout: `wx` [D, 3H], `wh` [H, 3H], `bias_x`, `bias_h` [3H]
    (names with 'bias', so the weight decay skips them as in the JAX
    package), gate order (r, z, n), all drawn U(-1/sqrt(H), 1/sqrt(H)):

      r = sigmoid(i_r + h_r); z = sigmoid(i_z + h_z); n = tanh(i_n + r * h_n)
      AGRU:  h' = (1 - a) h + a n
      AUGRU: z' = a z; h' = (1 - z') h + z' n
      AIGRU: the inputs scaled by a, then h' = (1 - z) h + z n

    where i_* = x W_x + b_x and h_* = h W_h + b_h. inputs [B, T, D], shared
    by the C candidates of a row (DIEN's interest states), att_scores
    [B, C, T], lengths [B] -> the final states [B, C, H]: a row stops
    updating at its length (0 for a row of length 0).

    AGRU's and AUGRU's gates take the score, so they run a loop over the T
    steps of [B, C, 3H] products, the input projection x W_x once per row
    (not per candidate). AIGRU's cell is a plain GRU over a x: with
    gradients, or up to CUDNN_MAX_ROWS rows B * C, it is one call of
    PyTorch's GRU (cuDNN on the card) over the [B * C, T, D] rows, whose
    update gate is 1 - z (its z rows enter negated: sigmoid(-x) =
    1 - sigmoid(x)); past that, in evaluation, the same loop, with
    (a x) W_x = a (x W_x), which materialises no [B * C, T, D] input. On an
    NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), DIEN's evaluation batch of
    3,200 rows (32 x 100 candidates) took 2.7-3.5 s a dev split through the
    loop and 1.3-1.4 s through cuDNN, its full-catalog batch of 278,848
    rows 45 ms through the loop and 113 ms through cuDNN's persistent
    kernel."""

    CUDNN_MAX_ROWS = 1 << 16

    def __init__(self, in_features: int, hidden: int, gru_type: str = "AUGRU"):
        super().__init__()
        if gru_type not in ("AGRU", "AUGRU", "AIGRU"):
            raise ValueError(f"Unknown evolving GRU type: {gru_type}")
        self.hidden, self.gru_type = hidden, gru_type
        self.wx = nn.Parameter(torch.empty(in_features, 3 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.bias_x = nn.Parameter(torch.empty(3 * hidden))
        self.bias_h = nn.Parameter(torch.empty(3 * hidden))
        u = _uniform(1.0 / math.sqrt(hidden))
        self.PARAM_INITS = {"wx": u, "wh": u, "bias_x": u, "bias_h": u}

    def forward(self, inputs, att_scores, lengths):
        if self.gru_type == "AIGRU" and (torch.is_grad_enabled()
                                         or inputs.shape[0] * att_scores.shape[1] <= self.CUDNN_MAX_ROWS):
            return self._cudnn_aigru(inputs, att_scores, lengths)
        B, T, _ = inputs.shape
        C, Hs = att_scores.shape[1], self.hidden
        xw = torch.matmul(inputs, self.wx)                        # [B, T, 3H]
        aigru = self.gru_type == "AIGRU"
        if not aigru:
            xw = xw + self.bias_x
        valid = (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]).to(inputs.dtype)
        # each step's update weight: 0 past a row's length, AGRU's a
        weight = valid[:, None, :] * (att_scores if self.gru_type == "AGRU" else 1.0)
        h = inputs.new_zeros(B, C, Hs)
        for t in range(T):
            x_t = xw[:, t, None, :]
            gi = torch.addcmul(self.bias_x, att_scores[:, :, t, None], x_t) if aigru else x_t
            gh = torch.addmm(self.bias_h, h.view(B * C, Hs), self.wh).view(B, C, 3 * Hs)
            r, z = torch.sigmoid(gi[..., :2 * Hs] + gh[..., :2 * Hs]).chunk(2, dim=-1)
            n = torch.tanh(torch.addcmul(gi[..., 2 * Hs:], r, gh[..., 2 * Hs:]))
            w = weight[:, :, t, None]
            if self.gru_type == "AUGRU":
                w = w * att_scores[:, :, t, None] * z
            elif aigru:
                w = w * z
            h = torch.lerp(h, n, w)                                # (1 - w) h + w n
        return h

    def _cudnn_aigru(self, inputs, att_scores, lengths):
        B, T, D = inputs.shape
        C, Hs = att_scores.shape[1], self.hidden
        x = (inputs[:, None] * att_scores[..., None]).reshape(B * C, T, D)
        flip = torch.ones(3 * Hs, device=inputs.device, dtype=inputs.dtype)
        flip[Hs: 2 * Hs] = -1.0
        # cuDNN takes contiguous [3H, in] weights in PyTorch's gate layout
        params = [(self.wx * flip).t().contiguous(), (self.wh * flip).t().contiguous(),
                  self.bias_x * flip, self.bias_h * flip]
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            # (input, hx, params, has_biases, num_layers, dropout, train,
            # bidirectional, batch_first)
            outputs, _ = torch._VF.gru(x, inputs.new_zeros(1, B * C, Hs), params, True, 1, 0.0,
                                       True, False, True)
        last = (lengths - 1).clamp(min=0).repeat_interleave(C)
        h = outputs.gather(1, last[:, None, None].expand(B * C, 1, Hs))[:, 0].view(B, C, Hs)
        return torch.where((lengths > 0)[:, None, None], h, torch.zeros_like(h))


class LSTMCell(nn.Module):
    """flax `nn.OptimizedLSTMCell`'s parameters in its layout: input
    projections `ii`, `if`, `ig`, `io` without biases, recurrent `hi`, `hf`,
    `hg`, `ho` with them; lecun-normal input kernels, orthogonal recurrent
    kernels, zero biases.

      i = sigmoid(ii(x) + hi(h)); f = sigmoid(if(x) + hf(h))
      g = tanh(ig(x) + hg(h)); o = sigmoid(io(x) + ho(h))
      c' = f * c + i * g; h' = o * tanh(c')
    """

    GATES = ("i", "f", "g", "o")     # torch's LSTM gate order too

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for gate in self.GATES:
            self.add_module("i" + gate, Dense(in_features, hidden, False, _lecun_normal, _zeros))
            self.add_module("h" + gate, Dense(hidden, hidden, True, _orthogonal, _zeros))

    def stacked(self):
        """[w_ih, w_hh, b_ih, b_hh] as PyTorch's LSTM kernels take them,
        with the input bias held at zero (not a parameter)."""
        w_h = [getattr(self, "h" + g) for g in self.GATES]
        b_hh = torch.cat([m.bias for m in w_h])
        return [torch.cat([getattr(self, "i" + g).weight for g in self.GATES]),
                torch.cat([m.weight for m in w_h]), torch.zeros_like(b_hh), b_hh]


class _LSTMDirection(nn.Module):
    """One direction of `BiLSTM` (flax `nn.RNN`), its cell at `cell` as in
    the flax tree."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.cell = LSTMCell(in_features, hidden)

    def forward(self, seq):
        """[B, L, H] outputs of the cell run from zero state over all L steps
        (one call of PyTorch's LSTM, cuDNN on the card)."""
        h0 = seq.new_zeros(1, seq.shape[0], self.cell.hidden)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            # (input, hx, params, has_biases, num_layers, dropout, train,
            # bidirectional, batch_first)
            out, _, _ = torch._VF.lstm(seq.contiguous(), (h0, h0), self.cell.stacked(), True, 1, 0.0,
                                       torch.is_grad_enabled(), False, True)
        return out


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax's `flip_sequences` over [B, L, ...]: each row's first `lengths`
    steps reversed and its padding steps reversed among themselves (time
    index (L - 1 - t + length) mod L); an involution."""
    B, L = x.shape[:2]
    idx = torch.remainder(L - 1 - torch.arange(L, device=x.device)[None, :] + lengths[:, None], L)
    return x.gather(1, idx.reshape(B, L, *([1] * (x.dim() - 2))).expand(x.shape))


class BiLSTM(nn.Module):
    """Bidirectional LSTM over left-aligned padded sequences -> [B, L, 2H]
    (port of rechorus_tpu/ops/layers.py:362-376: flax `nn.RNN` of
    `OptimizedLSTMCell` forward, and reversed with `keep_order=True` and
    `seq_lengths` backward). The forward direction runs over all L steps;
    the backward one over each row flipped by `flip_sequences`, its outputs
    flipped back. As in flax, the outputs at pad steps are the cell
    continued over the pad inputs: mask them before use where it matters."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.fwd = _LSTMDirection(in_features, hidden)
        self.bwd = _LSTMDirection(in_features, hidden)

    def forward(self, seq, lengths):
        out_f = self.fwd(seq)
        out_b = flip_sequences(self.bwd(flip_sequences(seq, lengths)), lengths)
        return torch.cat([out_f, out_b], dim=-1)


# the attention maps `MultiHeadAttention` keeps for `BaseRunner.check`
# (the JAX layer `sow`s them): off unless `record_intermediates` is open
_RECORD = False


def recording() -> bool:
    """Whether `record_intermediates` is open."""
    return _RECORD


@contextmanager
def record_intermediates():
    """While open, every MultiHeadAttention keeps its last attention map
    in `.intermediates`; on exit they are cleared."""
    global _RECORD
    _RECORD = True
    try:
        yield
    finally:
        _RECORD = False


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention with the reference's -inf mask and
    NaN-to-0 guard (src/utils/layers.py:9-63): two products, a mask,
    softmax and `nan_to_num`, written out (a fused library attention has
    no NaN guard and would hide the map from `check()`). The projections
    map d_model to `attention_d` (d_model when not positive, reference
    :17-20), and `out_proj` adds a torch-style output projection."""

    def __init__(self, d_model: int, n_heads: int, kq_same: bool = False, use_bias: bool = True,
                 attention_d: int = -1, out_proj: bool = False):
        super().__init__()
        self.att_d = attention_d if attention_d > 0 else d_model
        self.d_model, self.n_heads, self.kq_same = d_model, n_heads, kq_same
        self.k = Dense(d_model, self.att_d, use_bias)
        if not kq_same:
            self.q = Dense(d_model, self.att_d, use_bias)
        self.v = Dense(d_model, self.att_d, use_bias)
        if out_proj:
            self.out_proj = Dense(self.att_d, self.att_d, use_bias)
        self.has_out_proj = out_proj
        self.intermediates = None

    def forward(self, q, k, v, mask=None):
        d_k = self.att_d // self.n_heads

        def heads(x):
            return x.reshape(x.shape[:-1] + (self.n_heads, d_k)).transpose(-2, -3)

        qh = heads(self.k(q) if self.kq_same else self.q(q))
        kh, vh = heads(self.k(k)), heads(self.v(v))
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d_k)
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        attn = torch.nan_to_num(torch.softmax(scores, dim=-1))   # fully masked rows -> 0
        self.intermediates = {"attention": attn.detach()} if _RECORD else None
        out = torch.matmul(attn, vh).transpose(-2, -3)
        out = out.reshape(out.shape[:-2] + (self.att_d,))
        return self.out_proj(out) if self.has_out_proj else out


class MultiHeadTargetAttention(nn.Module):
    """Target attention, one query per candidate over a shared history
    (port of rechorus_tpu/ops/layers.py:377-419; FuxiCTR-derived, reference
    layers.py:121-198): target [B, C, D], history [B, H, D], mask [B, C, H]
    (True = attend) -> [B, C, D]. With `use_qkvo` the bias-free projections
    `W_q`, `W_k`, `W_v` map D to `attention_dim` and `W_o` back; masked
    scores are -1e9 before the softmax (a fully masked row attends
    uniformly, as in the JAX layer); the attention weights take dropout
    from the step's generator."""

    def __init__(self, input_dim: int = 64, attention_dim: int = 64, num_heads: int = 1,
                 dropout_rate: float = 0.0, use_scale: bool = True, use_qkvo: bool = True):
        super().__init__()
        self.input_dim, self.num_heads = input_dim, num_heads
        self.dropout_rate, self.use_scale, self.use_qkvo = dropout_rate, use_scale, use_qkvo
        self.att_dim = attention_dim if use_qkvo else input_dim
        if use_qkvo:
            self.W_q = Dense(input_dim, self.att_dim, use_bias=False)
            self.W_k = Dense(input_dim, self.att_dim, use_bias=False)
            self.W_v = Dense(input_dim, self.att_dim, use_bias=False)
            self.W_o = Dense(self.att_dim, input_dim, use_bias=False)

    def forward(self, target, history, mask=None, training: bool = False, gen=None):
        if self.use_qkvo:
            q, k, v = self.W_q(target), self.W_k(history), self.W_v(history)
        else:
            q, k, v = target, history, history
        B, C = q.shape[:2]
        H, n = k.shape[1], self.num_heads
        hd = self.att_dim // n
        qh = q.reshape(B, C, n, hd).transpose(1, 2)              # [B, n, C, hd]
        kh = k.reshape(B, H, n, hd).transpose(1, 2)              # [B, n, H, hd]
        vh = v.reshape(B, H, n, hd).transpose(1, 2)
        scores = torch.matmul(qh, kh.transpose(-1, -2))          # [B, n, C, H]
        if self.use_scale:
            scores = scores / (hd ** 0.5)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None], -1.0e9)
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout_rate, training, gen)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, C, self.att_dim)
        return self.W_o(out) if self.use_qkvo else out


class TransformerLayer(nn.Module):
    """Post-LN residual block (reference layers.py:92-118), LayerNorm eps
    1e-5 as torch's; `out_proj` gives the attention its output projection
    (PRM's encoder)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int, dropout: float = 0.0,
                 kq_same: bool = False, out_proj: bool = False):
        super().__init__()
        self.dropout = dropout
        self.mha = MultiHeadAttention(d_model, n_heads, kq_same=kq_same, out_proj=out_proj)
        self.ln1 = LayerNorm(d_model)
        self.ff1 = Dense(d_model, d_ff)
        self.ff2 = Dense(d_ff, d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, seq, mask=None, training: bool = False, gen=None):
        context = dropout(self.mha(seq, seq, seq, mask=mask), self.dropout, training, gen)
        context = self.ln1(context + seq)
        ff = self.ff2(torch.relu(self.ff1(context)))
        return self.ln2(dropout(ff, self.dropout, training, gen) + context)
