"""Exact full-catalog top-k and ranks for large catalogs (port of the
kernel route of rechorus_tpu/ops/topk.py).

At serving scale the [B, N] score matrix does not fit (B=4096 x N=1M f32
is 16 GB) and a full top-k over N columns is the bottleneck. Both
functions here stream the catalog through the fused kernels of
`ops.cuda_topk`, so the score matrix never exists:

`tiled_catalog_topk` -- hierarchical exact top-k:
  1. `fused_bucket_max`: per strided bucket of `bucket` items, the
     masked max score ([B, G] with G = N / bucket, rounded up to 128).
  2. Exact top `k+M` buckets (`two_level_bucket_select` on wide G: one
     `bucket_select` launch; the k+M in no particular order).
  3. Rescore only the winning buckets' items ((k+M)*bucket per user)
     from the grouped copy (`group_table_for_rescore`, built once per
     table by the caller: `rescore_copy`), in one `bucket_rescore` launch
     that reads each selected slice once. Knock out clicked ids, final
     top-k.

  Exactness: let v* be the k-th largest unmasked score. Every bucket
  holding a true top-k item has max >= v*. Buckets with max >= v* are
  (a) those whose max is itself a top-k item (<= k) or (b) those whose
  max is an excluded clicked item scoring >= v* (<= M). So the top k+M
  buckets contain every winner, and rescoring them recovers the exact
  top-k. Both stages are FP32 (no TF32). On the card the rescore sums as
  B2 does, so each rescored score is, bit for bit, the one B2 took its
  bucket maximum over, on one device and on every shard alike; the CPU's
  plain versions agree with B2 up to summation order. Results can differ
  from a dense top-k only on near-ties.

`tiled_catalog_ranks` -- ground-truth rank for `--test_all`: the fused
  >=-count over the catalog minus clicked corrections by gather.

Both take a multi-interest model's K user vectors, u [B, K, D], whose
score is the max over k: the ranks count with `fused_ge_count`, which
takes the max before its compare, the top-k runs B2 over the B * K rows
and reduces the bucket maxima by max.

`approx_max_k` -- the approximate select of the approx lane (the TPU's
  `lax.approx_max_k`): `cuda_topk.approx_bin_max` reduces each row to L
  strided bin maxima, then an exact top-k over them. `tiled_catalog_topk`
  with `approx=True` selects its k+M buckets so, and rescores them as the
  exact lane does; `metrics.masked_topk` selects over dense scores.

There is one route: on CUDA tensors the kernels launch; on CPU tensors
their plain versions run, so CPU tests walk the same code. The JAX
package's scan route is not ported. On the CPU `lax.approx_max_k` falls
back to an exact top-k; `approx_max_k` here approximates on every device.
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.utils.spans import span

# route serving through the tiled path at this table size (JAX package,
# rechorus_tpu/ops/topk.py:50)
MIN_ROWS_FOR_TILED = 16384
# with --approx_topk the runner selects over dense [B, N] scores up to this
# many elements and takes the tiled approx lane above (JAX package,
# rechorus_tpu/ops/topk.py:58)
DENSE_APPROX_MAX_ELEMS = 1 << 29
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
    matrix via a CONTIGUOUS two-level select (`cuda_topk.bucket_select`:
    super-buckets of F columns, top-kk of their maxima, top-kk of the
    winners' members), in one launch on the card.

    Exact because every column >= v* (the kk-th largest) lives in a super
    with max >= v*, and at most kk supers have one. The kk come back in no
    particular order, and on exact f32 ties at the kk boundary the id
    reported among tied columns may differ from a direct top-k. Where the
    gather would cover (nearly) the whole matrix (G <= F * kk) the direct
    `torch.topk` runs, values descending; when kk >= G the output narrows
    to G columns. On the card a shape past the kernel's limits
    (`cuda_topk.bucket_select_fits`) raises.
    """
    G = bm.shape[1]
    if fan is None:
        fan = _two_level_fan(G)
    if G <= fan * kk:
        return torch.topk(bm, min(kk, G), dim=1)
    return CT.bucket_select(bm, kk, fan)


def approx_max_k(x: torch.Tensor, k: int, recall_target: float = 0.98):
    """Approximate top-k (values [B, k'], int64 columns [B, k']) of x [B, N],
    k' = min(k, N), values descending: the maxima of L strided bins
    (`cuda_topk.approx_bin_max`, L from `cuda_topk.approx_bins`), then the
    exact top-k' of those. Each returned value is x at its column. A top-k
    element is missed only when a larger one shares its bin; where L = N
    (recall_target 1, or too few columns to reduce) it is the exact top-k."""
    k = min(k, x.shape[1])
    L = CT.approx_bins(x.shape[1], k, recall_target)
    if L >= x.shape[1]:
        return torch.topk(x, k, dim=1)
    vals, cols = CT.approx_bin_max(x.contiguous(), L)
    v, sel = torch.topk(vals, k, dim=1)
    return v, cols.gather(1, sel).long()


def group_table_for_rescore(table: torch.Tensor, bucket: int | None = None,
                            nb: int = CT.NB) -> torch.Tensor:
    """One-time [Gp, bucket, D] copy of `table` in which each STRIDED
    bucket's members (`fused_bucket_max` partition: bucket g = rows
    (g//nb)*bucket*nb + g%nb + arange(bucket)*nb) are contiguous, so the
    rescore reads one slice per selected bucket instead of `bucket`
    scattered rows. Overhang slots repeat row N-1 (masked at rescore)."""
    bucket = bucket or DEFAULT_BUCKET
    N = table.shape[0]
    n_blocks = -(-N // (bucket * nb))
    g = torch.arange(n_blocks * nb, device=table.device)
    old = ((g[:, None] // nb) * (bucket * nb) + g[:, None] % nb
           + torch.arange(bucket, device=table.device)[None, :] * nb)
    return table[old.clamp(max=N - 1)]


def rescore_copy(table: torch.Tensor) -> torch.Tensor | None:
    """The grouped copy `tiled_catalog_topk` rescores from, for a table of
    at least MIN_ROWS_FOR_TILED rows (the tiled route); None for a smaller
    one, which takes the dense route. Build it once per table, outside any
    batch loop."""
    if table.shape[0] >= MIN_ROWS_FOR_TILED:
        return group_table_for_rescore(table)
    return None


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


def tiled_catalog_topk(u, table, k: int, *, grouped_table, bias=None, clicked_rows=None,
                       n_valid: int | None = None, bucket: int | None = None,
                       approx: bool = False, recall_target: float = 0.98,
                       col_offset: int = 0):
    """Exact masked top-k over u @ table.T + bias without the [B, N]
    matrix. Returns (values [B, k] float32, GLOBAL item ids [B, k] int32).

    `approx=True` selects the k+M buckets with `approx_max_k` at
    `recall_target` instead of exactly; their items are rescored exactly,
    so every value is its id's score and only recall can drop.
    `table` holds global rows [col_offset, col_offset + N); masks,
    clicked comparisons and returned ids are global (n_valid too).
    `grouped_table` is `group_table_for_rescore(table, bucket)`, built
    once per table by the caller.

    For a multi-interest model u is [B, K, D] and a score is the max over
    its K rows: B2 runs over the B * K rows and each user's K bucket
    maxima reduce by max (a bucket's max of the max-score is the max of
    the K bucket maxima, exactly); the select is the same, and the
    rescore takes the max over k."""
    bucket = bucket or DEFAULT_BUCKET
    N = table.shape[0]
    M = clicked_rows.shape[1] if clicked_rows is not None else 0
    k_wide = min(k + M, N)
    if grouped_table.shape[1] != bucket or grouped_table.shape[0] * bucket < N:
        # a copy grouped for another partition would pair candidate IDS
        # from one partition with VECTORS from another
        raise ValueError(
            f"grouped_table {tuple(grouped_table.shape)} does not match bucket={bucket}, "
            f"N={N}; rebuild it with group_table_for_rescore(table, bucket=...)")

    with span("topk.bucket_max"):
        if u.dim() == 3:
            B, K, D = u.shape
            u = u.contiguous()
            bm = CT.fused_bucket_max(u.view(B * K, D), table, bucket=bucket,
                                     bias=bias, n_valid=n_valid, col_offset=col_offset)
            bm = bm.view(B, K, -1).amax(1)
        else:
            bm = CT.fused_bucket_max(u, table, bucket=bucket, bias=bias, n_valid=n_valid,
                                     col_offset=col_offset)
    with span("topk.select"):
        kk = min(k_wide, bm.shape[1])
        if approx:
            gv, gb = approx_max_k(bm, kk, recall_target)
        elif bm.shape[1] >= TWO_LEVEL_MIN_G:
            gv, gb = two_level_bucket_select(bm, kk)
        else:
            gv, gb = torch.topk(bm, kk, dim=1)
        del bm
    with span("topk.rescore"):
        cs, cand = CT.bucket_rescore(u, grouped_table, gb, gv, n_rows=N, bias=bias,
                                     n_valid=n_valid, col_offset=col_offset)
    with span("topk.final"):
        return _final_select(cs, cand, k, k_wide, clicked_rows, col_offset)


def tiled_catalog_ranks(u, table, target_col, clicked_rows, bias=None,
                        n_valid: int | None = None) -> torch.Tensor:
    """Ground-truth catalog rank with clicked masking, without the [B, N]
    matrix (same result as `cuda_kernels.catalog_ranks` over dense
    scores). Returns [B] int32:

      rank = 1 + #{j: s_j >= s_t} - #{clicked j: s_j >= s_t} - [s_0 >= s_t]

    u [B, D], or [B, K, D] for a multi-interest model, whose score
    s_j = max_k u[:, k] . table[j] (+ bias[j]) is counted by
    `fused_ge_count` and taken the same way for the target and the
    clicked ids."""
    target_col = target_col.to(torch.int32).contiguous()
    tidx = target_col.long()
    if u.dim() == 3:
        tscore = CT.row_scores(u, table[tidx][:, None, :])[:, 0]
    else:
        tscore = (u * table[tidx]).sum(-1)
    if bias is not None:
        tscore = tscore + bias[tidx]
    # the target's own column is excluded by id in the kernel (its kernel
    # score and tscore may differ by an ulp); the epilogue re-adds it
    total = CT.fused_ge_count(u, table, tscore.contiguous(), target_col=target_col, bias=bias,
                              n_valid=n_valid)
    return _ranks_epilogue(u, table, bias, target_col, tscore, clicked_rows, total)


def _ranks_epilogue(u, table, bias, target_col, tscore, clicked_rows, total):
    clicked = clicked_rows.long()
    cscore = CT.row_scores(u, table[clicked])                           # [B, M]
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


def tiled_ge_count(u, table, tscore, bias=None, clicked_rows=None,
                   n_valid: int | None = None, col_offset: int = 0, target_col=None):
    """#{rows: score >= tscore[b]} over a table that holds global rows
    [col_offset, col_offset + N), excluding by GLOBAL id row 0, dead rows
    (>= n_valid), the clicked ids and `target_col[b]`, the column whose
    score defines tscore (port of the kernel branch of JAX
    ops/topk.py::tiled_ge_count): the building block of the sharded ranks
    (parallel/topk.py). Returns [B] int32.

    The fused count (B3, `fused_ge_count`) excludes row 0, dead rows and
    the target; the clicked rows it counted are then subtracted by a
    gathered correction: the clicked rows that lie in this table, are
    above 0, below n_valid and not the target, scored by a [B, M, D]
    product. Clicked ids are unique per row by contract."""
    tc = None if target_col is None else target_col.to(torch.int32).contiguous()
    total = CT.fused_ge_count(u, table, tscore.contiguous(), target_col=tc, bias=bias,
                              n_valid=n_valid, col_offset=col_offset)
    if clicked_rows is None:
        return total
    N = table.shape[0]
    clicked = clicked_rows.long()
    local = clicked - col_offset
    in_shard = (local >= 0) & (local < N)
    rows = local.clamp(0, N - 1)
    cs = torch.matmul(table[rows], u[:, :, None])[:, :, 0]             # [B, M]
    if bias is not None:
        cs = cs + bias[rows]
    ok = in_shard & (clicked > 0)
    if n_valid is not None:
        ok &= clicked < n_valid
    if tc is not None:
        ok &= clicked != tc.long()[:, None]
    return total - ((cs >= tscore[:, None]) & ok).sum(1).to(torch.int32)
