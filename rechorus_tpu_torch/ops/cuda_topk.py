"""Fused stage-1 kernels of the streaming catalog top-k / rank path
(counterpart of rechorus_tpu/ops/pallas_topk.py).

Both kernels score a block of the catalog, `u @ table.T (+ bias)`, in
FP32 on the chip, reduce it there and write little, so the [B, N] score
matrix never reaches device memory:

`fused_bucket_max` -- stage 1 of the exact hierarchical top-k
  (`ops.topk.tiled_catalog_topk`). Per catalog block of `bucket * NB`
  rows it masks pad/col-0/dead rows and reduces to NB bucket maxima.
  Buckets are STRIDED within the block: bucket `l` of block `j` holds
  items `{j*bucket*NB + c*NB + l : c < bucket}` (pallas_topk.py:13-22),
  the partition `expand_bucket_items` and `topk.group_table_for_rescore`
  invert.

`fused_ge_count` -- per row, the count of catalog rows with score >=
  tscore[b] under the id masks (global id > 0, < n_valid, !=
  target_col[b]); clicked exclusion is the caller's gathered correction.

Masks live in GLOBAL id space: global id = local row + `col_offset`.
On CUDA tensors the wrappers launch `rtt_bucket_max_kernel` /
`rtt_fused_ge_kernel` (csrc/catalog_kernels.cu); on CPU tensors they run
the `*_plain` versions, which materialize the masked scores.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from rechorus_tpu_torch.ops import _build

NB = 128  # bucket maxima per catalog block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_ok(N: int, n_valid, col_offset: int, device) -> torch.Tensor:
    """[N] bool: global id > 0 and < n_valid."""
    gid = torch.arange(N, device=device) + col_offset
    ok = gid > 0
    if n_valid is not None:
        ok &= gid < n_valid
    return ok


def _scores(u, table, bias):
    s = u @ table.T
    if bias is not None:
        s += bias[None, :]
    return s


def fused_bucket_max_plain(u, table, *, bucket: int, bias=None, n_valid=None,
                           col_offset: int = 0) -> torch.Tensor:
    """[B, cdiv(N, bucket*NB)*NB] strided-bucket maxima of the masked scores."""
    B, N = u.shape[0], table.shape[0]
    s = _scores(u, table, bias)
    s.masked_fill_(~_row_ok(N, n_valid, col_offset, s.device)[None, :], float("-inf"))
    n_blocks = _cdiv(N, bucket * NB)
    s = F.pad(s, (0, n_blocks * bucket * NB - N), value=float("-inf"))
    return s.view(B, n_blocks, bucket, NB).amax(2).reshape(B, n_blocks * NB)


def fused_bucket_max(u, table, *, bucket: int, bias=None, n_valid=None,
                     col_offset: int = 0) -> torch.Tensor:
    """[B, cdiv(N, bucket*NB)*NB] float32 strided-bucket maxima of the
    masked score matrix u @ table.T (+ bias). Bucket g covers items
    `(g // NB) * bucket * NB + g % NB + arange(bucket) * NB`; masked and
    overhang slots are -inf. u [B, D], table [N, D], bias [N], all float32."""
    if u.device.type == "cpu":
        return fused_bucket_max_plain(u, table, bucket=bucket, bias=bias, n_valid=n_valid,
                                      col_offset=col_offset)
    if u.device.type != "cuda":
        raise ValueError(f"fused_bucket_max: no kernel for device {u.device}")
    (B, D), N, dev = u.shape, table.shape[0], u.device
    _build.check_input("fused_bucket_max", "u", u, torch.float32, (B, D), dev)
    _build.check_input("fused_bucket_max", "table", table, torch.float32, (N, D), dev)
    if bias is not None:
        _build.check_input("fused_bucket_max", "bias", bias, torch.float32, (N,), dev)
    if bucket < 1 or D < 1:
        raise ValueError(f"fused_bucket_max: bucket={bucket}, D={D}")
    n_valid_c = -1 if n_valid is None else int(n_valid)
    _build.check_int32("fused_bucket_max", B=B, N=N, D=D, bucket=bucket * NB,
                       n_valid=n_valid_c, col_offset=int(col_offset))
    out = torch.empty(B, _cdiv(N, bucket * NB) * NB, dtype=torch.float32, device=dev)
    if B and N:
        _build.launch("rtt_fused_bucket_max", dev, _build.ptr(u), _build.ptr(table),
                      _build.ptr(bias), _build.ptr(out), B, N, D, int(bucket), n_valid_c,
                      int(col_offset))
        fused_bucket_max.launches += 1
    return out


fused_bucket_max.launches = 0


def expand_bucket_items(gb: torch.Tensor, bucket: int, nb: int = NB) -> torch.Tensor:
    """Strided-bucket ids [B, kk] -> candidate LOCAL item ids [B, kk*bucket]
    (the stage-2 counterpart of `fused_bucket_max`'s partition)."""
    base = (gb // nb) * (bucket * nb) + gb % nb
    items = base[:, :, None] + (torch.arange(bucket, dtype=gb.dtype, device=gb.device) * nb)
    return items.reshape(gb.shape[0], -1)


def fused_ge_count_plain(u, table, tscore, *, target_col=None, bias=None, n_valid=None,
                         col_offset: int = 0) -> torch.Tensor:
    """[B] int32 `#{row r: score(b, r) >= tscore[b]}` over rows passing the
    id masks, from the materialized score matrix."""
    N = table.shape[0]
    ge = _scores(u, table, bias) >= tscore[:, None]
    ge &= _row_ok(N, n_valid, col_offset, ge.device)[None, :]
    if target_col is not None:
        gid = torch.arange(N, device=ge.device) + col_offset
        ge &= gid[None, :] != target_col[:, None]
    return ge.sum(1).to(torch.int32)


def fused_ge_count(u, table, tscore, *, target_col=None, bias=None, n_valid=None,
                   col_offset: int = 0) -> torch.Tensor:
    """[B] int32 counts of `#{row r: score(b, r) >= tscore[b]}` over rows
    passing the id masks (global id > 0, < n_valid, != target_col[b]),
    score = u @ table.T (+ bias). u [B, D], table [N, D], tscore [B],
    bias [N] float32; target_col [B] int32."""
    if u.device.type == "cpu":
        return fused_ge_count_plain(u, table, tscore, target_col=target_col, bias=bias,
                                    n_valid=n_valid, col_offset=col_offset)
    if u.device.type != "cuda":
        raise ValueError(f"fused_ge_count: no kernel for device {u.device}")
    (B, D), N, dev = u.shape, table.shape[0], u.device
    _build.check_input("fused_ge_count", "u", u, torch.float32, (B, D), dev)
    _build.check_input("fused_ge_count", "table", table, torch.float32, (N, D), dev)
    _build.check_input("fused_ge_count", "tscore", tscore, torch.float32, (B,), dev)
    if target_col is not None:
        _build.check_input("fused_ge_count", "target_col", target_col, torch.int32, (B,), dev)
    if bias is not None:
        _build.check_input("fused_ge_count", "bias", bias, torch.float32, (N,), dev)
    if D < 1:
        raise ValueError(f"fused_ge_count: D={D}")
    n_valid_c = -1 if n_valid is None else int(n_valid)
    _build.check_int32("fused_ge_count", B=B, N=N, D=D, n_valid=n_valid_c,
                       col_offset=int(col_offset))
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    if B and N:
        _build.launch("rtt_fused_ge_count", dev, _build.ptr(u), _build.ptr(table),
                      _build.ptr(tscore), _build.ptr(target_col), _build.ptr(bias),
                      _build.ptr(counts), B, N, D, n_valid_c, int(col_offset))
        fused_ge_count.launches += 1
    return counts


fused_ge_count.launches = 0
