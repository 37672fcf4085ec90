"""Exact full-catalog top-k and ranks for large catalogs (port of the
kernel route of rechorus_tpu/ops/topk.py).

At serving scale the [B, N] score matrix does not fit (B=4096 x N=1M f32
is 16 GB) and a full top-k over N columns is the bottleneck. Both
functions here stream the catalog through the fused kernels of
`ops.cuda_topk`, so the score matrix never exists:

`tiled_catalog_topk` -- hierarchical exact top-k:
  1. `fused_bucket_max`: per strided bucket of `bucket` items, the
     masked max score ([B, G] with G = N / bucket, rounded up to 128).
  2. Exact top `k+M` buckets (`two_level_bucket_select` on wide G).
  3. Rescore only the winning buckets' items ((k+M)*bucket per user,
     from the grouped copy `group_table_for_rescore` when given), knock
     out clicked ids, final top-k.

  Exactness: let v* be the k-th largest unmasked score. Every bucket
  holding a true top-k item has max >= v*. Buckets with max >= v* are
  (a) those whose max is itself a top-k item (<= k) or (b) those whose
  max is an excluded clicked item scoring >= v* (<= M). So the top k+M
  buckets contain every winner, and rescoring them recovers the exact
  top-k. The bucket maxima and the rescore are both FP32 (no TF32), so
  they agree up to summation order: results can differ from a dense
  top-k only on near-ties.

`tiled_catalog_ranks` -- ground-truth rank for `--test_all`: the fused
  >=-count over the catalog minus clicked corrections by gather.

There is one route: on CUDA tensors the kernels launch; on CPU tensors
their plain versions run, so CPU tests walk the same code. The approx
lane (`lax.approx_max_k`) and the scan route are not ported.
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.ops import cuda_topk as CT

# route serving through the tiled path at this table size (JAX package,
# rechorus_tpu/ops/topk.py:50)
MIN_ROWS_FOR_TILED = 16384
DEFAULT_BUCKET = 16
# contiguous two-level exact bucket select: fan by bucket-matrix width,
# used at/above TWO_LEVEL_MIN_G (JAX package constants, topk.py:150-158)
TWO_LEVEL_FAN_WIDE = 16
TWO_LEVEL_FAN_NARROW = 8
TWO_LEVEL_WIDE_G = 32768
TWO_LEVEL_MIN_G = 6144


def _two_level_fan(G: int) -> int:
    return TWO_LEVEL_FAN_NARROW if G < TWO_LEVEL_WIDE_G else TWO_LEVEL_FAN_WIDE


def two_level_bucket_select(bm: torch.Tensor, kk: int, fan: int | None = None):
    """Exact top-kk (values, column ids) over a wide [B, G] bucket-max
    matrix via a CONTIGUOUS two-level select: reshape to [B, G/F, F]
    super-buckets, top-kk of the super maxima, gather the winners' F
    contiguous members, top-kk of those.

    Exact because every column >= v* (the kk-th largest) lives in a super
    with max >= v*, and at most kk supers have one. On exact f32 ties at
    the kk boundary the id reported among tied columns may differ from a
    direct top-k. When kk >= G the output narrows to G columns.
    """
    B, G = bm.shape
    if fan is None:
        fan = _two_level_fan(G)
    if kk >= G or G <= fan * kk:
        return torch.topk(bm, min(kk, G), dim=1)
    pad = (-G) % fan
    if pad:
        bm = torch.nn.functional.pad(bm, (0, pad), value=float("-inf"))
    mem = bm.view(B, -1, fan)                                          # [B, S, F]
    _, sb = torch.topk(mem.amax(-1), kk, dim=1)                        # [B, kk]
    rows = mem.gather(1, sb[:, :, None].expand(B, kk, fan))            # [B, kk, F]
    gb_all = sb[:, :, None] * fan + torch.arange(fan, device=bm.device)
    v, sel = torch.topk(rows.reshape(B, -1), kk, dim=1)
    return v, gb_all.reshape(B, -1).gather(1, sel)


def group_table_for_rescore(table: torch.Tensor, bucket: int | None = None,
                            nb: int = CT.NB) -> torch.Tensor:
    """One-time [Gp, bucket, D] copy of `table` in which each STRIDED
    bucket's members (`fused_bucket_max` partition: bucket g = rows
    (g//nb)*bucket*nb + g%nb + arange(bucket)*nb) are contiguous, so the
    rescore gathers one slice per selected bucket instead of `bucket`
    scattered rows. Overhang slots repeat row N-1 (masked at rescore)."""
    bucket = bucket or DEFAULT_BUCKET
    N = table.shape[0]
    n_blocks = -(-N // (bucket * nb))
    g = torch.arange(n_blocks * nb, device=table.device)
    old = ((g[:, None] // nb) * (bucket * nb) + g[:, None] % nb
           + torch.arange(bucket, device=table.device)[None, :] * nb)
    return table[old.clamp(max=N - 1)]


def _mask_candidates(cs, raw_cand, bias, col_offset, n_valid, n_rows):
    """Bias and id masks for rescored candidates; out-of-range expansions
    (the last bucket's overhang, pad slots) score -inf rather than
    clamping into duplicate copies of row n_rows-1."""
    in_range = raw_cand < n_rows
    cand = raw_cand.clamp(max=n_rows - 1)
    if bias is not None:
        cs = cs + bias[cand]
    gcand = cand + col_offset
    ok = in_range & (gcand > 0)
    if n_valid is not None:
        ok &= gcand < n_valid
    return cs.masked_fill(~ok, float("-inf")), cand


def _exact_rescore_grouped(u, grouped, bias, gb, raw_cand, col_offset, n_valid, n_rows):
    """Rescore candidates whose vectors come from the grouped copy's
    [B, kk] slice gathers; masks and ids use `raw_cand`."""
    B, kk = gb.shape
    cvec = grouped[gb.clamp(max=grouped.shape[0] - 1)]                  # [B, kk, bucket, D]
    cs = torch.matmul(cvec.view(B, -1, cvec.shape[-1]), u[:, :, None])[:, :, 0]
    del cvec
    return _mask_candidates(cs, raw_cand, bias, col_offset, n_valid, n_rows)


def _exact_rescore(u, table, bias, raw_cand, col_offset, n_valid, n_rows):
    """Gather the candidate rows, rescore, mask by global id."""
    cvec = table[raw_cand.clamp(max=n_rows - 1)]                        # [B, C, D]
    cs = torch.matmul(cvec, u[:, :, None])[:, :, 0]
    return _mask_candidates(cs, raw_cand, bias, col_offset, n_valid, n_rows)


def _final_select(cs, cand, k, k_wide, clicked_rows, col_offset):
    """Top-k over rescored candidates + clicked knockout; ids -> global."""
    kw = min(k_wide, cs.shape[1])
    v, sel = torch.topk(cs, kw, dim=1)
    ids = cand.gather(1, sel) + col_offset
    if clicked_rows is not None:
        hit = (ids[:, :, None] == clicked_rows[:, None, :].long()).any(-1)
        v = v.masked_fill(hit, float("-inf"))
        v, sel2 = torch.topk(v, min(k, kw), dim=1)
        ids = ids.gather(1, sel2)
    else:
        v, ids = v[:, :k], ids[:, :k]
    return v, ids.to(torch.int32)


def tiled_catalog_topk(u, table, k: int, *, bias=None, clicked_rows=None,
                       n_valid: int | None = None, bucket: int | None = None,
                       approx: bool = False, col_offset: int = 0, grouped_table=None):
    """Exact masked top-k over u @ table.T + bias without the [B, N]
    matrix. Returns (values [B, k] float32, GLOBAL item ids [B, k] int32).

    `table` holds global rows [col_offset, col_offset + N); masks,
    clicked comparisons and returned ids are global (n_valid too).
    `grouped_table` is `group_table_for_rescore(table, bucket)`."""
    if approx:
        raise NotImplementedError("approx lane not ported yet")
    bucket = bucket or DEFAULT_BUCKET
    N = table.shape[0]
    M = clicked_rows.shape[1] if clicked_rows is not None else 0
    k_wide = min(k + M, N)
    if grouped_table is not None and (grouped_table.shape[1] != bucket
                                      or grouped_table.shape[0] * bucket < N):
        # a copy grouped for another partition would pair candidate IDS
        # from one partition with VECTORS from another
        raise ValueError(
            f"grouped_table {tuple(grouped_table.shape)} does not match bucket={bucket}, "
            f"N={N}; rebuild it with group_table_for_rescore(table, bucket=...)")

    bm = CT.fused_bucket_max(u, table, bucket=bucket, bias=bias, n_valid=n_valid,
                             col_offset=col_offset)
    kk = min(k_wide, bm.shape[1])
    if bm.shape[1] >= TWO_LEVEL_MIN_G:
        gv, gb = two_level_bucket_select(bm, kk)
    else:
        gv, gb = torch.topk(bm, kk, dim=1)
    del bm
    raw_cand = CT.expand_bucket_items(gb, bucket)
    # a -inf selected bucket is a pad slot (fewer than kk finite buckets):
    # the strided expansion can alias it onto REAL items, so force its
    # expansion out of range for the rescore to mask
    pad_mask = torch.isneginf(gv).repeat_interleave(bucket, dim=1)
    raw_cand = raw_cand.masked_fill(pad_mask, N)
    if grouped_table is not None:
        cs, cand = _exact_rescore_grouped(u, grouped_table, bias, gb, raw_cand,
                                          col_offset, n_valid, N)
    else:
        cs, cand = _exact_rescore(u, table, bias, raw_cand, col_offset, n_valid, N)
    return _final_select(cs, cand, k, k_wide, clicked_rows, col_offset)


def tiled_catalog_ranks(u, table, target_col, clicked_rows, bias=None,
                        n_valid: int | None = None) -> torch.Tensor:
    """Ground-truth catalog rank with clicked masking, without the [B, N]
    matrix (same result as `cuda_kernels.catalog_ranks` over dense
    scores). Returns [B] int32:

      rank = 1 + #{j: s_j >= s_t} - #{clicked j: s_j >= s_t} - [s_0 >= s_t]
    """
    target_col = target_col.to(torch.int32).contiguous()
    tidx = target_col.long()
    tscore = (u * table[tidx]).sum(-1)
    if bias is not None:
        tscore = tscore + bias[tidx]
    # the target's own column is excluded by id in the kernel (its kernel
    # score and tscore may differ by an ulp); the epilogue re-adds it
    total = CT.fused_ge_count(u, table, tscore.contiguous(), target_col=target_col,
                              bias=bias, n_valid=n_valid)
    return _ranks_epilogue(u, table, bias, target_col, tscore, clicked_rows, total)


def _ranks_epilogue(u, table, bias, target_col, tscore, clicked_rows, total):
    clicked = clicked_rows.long()
    cscore = torch.matmul(table[clicked], u[:, :, None])[:, :, 0]       # [B, M]
    if bias is not None:
        cscore = cscore + bias[clicked]
    # the target's residual copy in clicked_rows is counted symbolically,
    # not by comparing two differently computed scores at equality
    not_target = clicked != target_col.long()[:, None]
    clicked_ge = ((cscore >= tscore[:, None]) & (clicked > 0) & not_target).sum(1)
    target_in_clicked = (~not_target).any(1).to(torch.int32)
    # dense rank = #{j>0: s_j >= t} - clicked_ge_dense + 1, where the
    # target's column contributes 1 to the count and its clicked copy 1 to
    # clicked_ge_dense; the fused count excludes col 0 and the target
    return (total + 2 - clicked_ge - target_in_clicked).to(torch.int32)
