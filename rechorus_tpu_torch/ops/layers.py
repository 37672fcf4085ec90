"""Shared torch blocks (port of rechorus_tpu/ops/layers.py:38-145,
:237-253, :320-359 and :422-444: `dense` and its init scheme, `TableEmbed`,
`embed`, the table dtype and the sparse-lookup context, dropout,
`MaskedGRU`, `MultiHeadAttention` and `TransformerLayer`).

Init convention of the reference BaseModel.init_weights
(src/models/BaseModel.py:29-35): N(0, 0.01) for embedding tables and
dense kernels and biases. Every parameter is drawn by
`BaseModel.init_weights` from one generator through `param_init` below;
a module names its parameters' initialisers in `PARAM_INITS` (the flax
initialisers of the JAX package's layer: LayerNorm ones and zeros, the
GRU cell's lecun-normal, orthogonal and zeros).

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
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))

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


def embed(num: int, dim: int, init=None) -> TableEmbed:
    """[num, dim] embedding table, N(0, 0.01) init from torch's global RNG,
    stored in the dtype of `set_table_dtype` (f32 unless --bf16_emb); `init`
    names the initialiser `BaseModel.init_weights` draws it from (default
    N(0, 0.01)). Every model-level table gather should go through this: a
    raw `weight[ids]` bypasses the bf16 storage cast AND the sparse-lookup
    context."""
    table = TableEmbed(num, dim, dtype=_TABLE_DTYPE)
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


# the attention maps `MultiHeadAttention` keeps for `BaseRunner.check`
# (the JAX layer `sow`s them): off unless `record_intermediates` is open
_RECORD = False


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
    no NaN guard and would hide the map from `check()`)."""

    def __init__(self, d_model: int, n_heads: int, kq_same: bool = False, use_bias: bool = True):
        super().__init__()
        self.d_model, self.n_heads, self.kq_same = d_model, n_heads, kq_same
        self.k = Dense(d_model, d_model, use_bias)
        if not kq_same:
            self.q = Dense(d_model, d_model, use_bias)
        self.v = Dense(d_model, d_model, use_bias)
        self.intermediates = None

    def forward(self, q, k, v, mask=None):
        d_k = self.d_model // self.n_heads

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
        return out.reshape(out.shape[:-2] + (self.d_model,))


class TransformerLayer(nn.Module):
    """Post-LN residual block (reference layers.py:92-118), LayerNorm eps
    1e-5 as torch's."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int, dropout: float = 0.0,
                 kq_same: bool = False):
        super().__init__()
        self.dropout = dropout
        self.mha = MultiHeadAttention(d_model, n_heads, kq_same=kq_same)
        self.ln1 = LayerNorm(d_model)
        self.ff1 = Dense(d_model, d_ff)
        self.ff2 = Dense(d_ff, d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, seq, mask=None, training: bool = False, gen=None):
        context = dropout(self.mha(seq, seq, seq, mask=mask), self.dropout, training, gen)
        context = self.ln1(context + seq)
        ff = self.ff2(torch.relu(self.ff1(context)))
        return self.ln2(dropout(ff, self.dropout, training, gen) + context)
