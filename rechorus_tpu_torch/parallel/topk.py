"""Full-catalog top-k and ranks over a row-sharded item table (port of
rechorus_tpu/parallel/topk.py).

Each rank of the 'model' group scores ITS rows and only small results
travel:

  * top-k: a local top-k per shard (`local_catalog_topk`, k << N/m), an
    all_gather of the k winners over 'model', a top-k of the m * k
    (`merge_topk`). Traffic O(B * m * k), not O(B * N);
  * ranks: the owner shard's target score (`local_target_score`) summed
    over 'model', each shard's >=-count with the clicked and pad masks
    (`local_ge_count`), the counts summed over 'model', + 1. Traffic O(B).

A shard of at least MIN_ROWS_FOR_TILED rows streams through the fused
kernels (B2 and the grouped rescore through `tiled_catalog_topk`, B3
through `tiled_ge_count`, with `col_offset` the shard's first global
row); a smaller one takes the dense masked [B, N/m] product. The caller
builds a tiled shard's grouped copy once (`ops.topk.rescore_copy`) and
hands it to the top-k. The per-shard parts take no collective, so one
card can run every shard of a table in turn (chip_smoke.py), merging by
`merge_topk` and sums where a mesh would call the collectives.
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.ops import topk as topk_ops
from rechorus_tpu_torch.parallel.mesh import all_gather_cat, masked_local_rows, sum_over

MIN_ROWS_FOR_TILED = topk_ops.MIN_ROWS_FOR_TILED


def _tiled(shard_n: int) -> bool:
    return shard_n >= MIN_ROWS_FOR_TILED


def _dense_scores(u, shard, bias):
    scores = u @ shard.T
    if bias is not None:
        scores = scores + bias[None, :]
    return scores


def _gids(offset: int, shard_n: int, device):
    return offset + torch.arange(shard_n, device=device)


def local_catalog_topk(u, shard, k: int, offset: int, n_valid: int, clicked_rows=None,
                       bias=None, grouped_table=None):
    """(values [B, kk], GLOBAL ids [B, kk] int32) of the top kk = min(k,
    N/m) of one shard holding global rows [offset, offset + N/m): id 0,
    ids >= n_valid and the clicked ids excluded. A tiled shard needs
    `grouped_table`, its `group_table_for_rescore` copy; a dense one
    takes none."""
    shard_n = shard.shape[0]
    kk = min(k, shard_n)
    if _tiled(shard_n):
        return topk_ops.tiled_catalog_topk(u, shard, kk, grouped_table=grouped_table, bias=bias,
                                           clicked_rows=clicked_rows, n_valid=n_valid,
                                           col_offset=offset)
    if clicked_rows is None:
        clicked_rows = torch.zeros((u.shape[0], 1), dtype=torch.long, device=u.device)
    scores = _dense_scores(u, shard, bias)
    gids = _gids(offset, shard_n, u.device)
    mask = (gids == 0) | (gids >= n_valid)
    mask = mask[None, :] | (gids[None, :, None] == clicked_rows.long()[:, None, :]).any(-1)
    v, i = torch.topk(scores.masked_fill(mask, float("-inf")), kk, dim=1)
    return v, (i + offset).to(torch.int32)


def merge_topk(values, ids, k: int):
    """Top-k of the shards' winners [B, m * kk] (concatenated in shard
    order): (values [B, k], ids [B, k])."""
    v, sel = torch.topk(values, min(k, values.shape[1]), dim=1)
    return v, ids.gather(1, sel)


def local_target_score(u, shard, target, offset: int, bias=None):
    """[B] the target's score on the shard that holds its row, 0 on the
    others: their sum over 'model' is the score. A tiled shard scores the
    row by a [B, D] product; a dense one reads it from the same [B, N/m]
    product its count compares against."""
    shard_n = shard.shape[0]
    if _tiled(shard_n):
        def score(row):
            tv = (u * shard[row]).sum(-1)
            return tv if bias is None else tv + bias[row]

        return masked_local_rows(score, target, offset, shard_n)
    scores = _dense_scores(u, shard, bias)
    gids = _gids(offset, shard_n, u.device)
    return torch.where(gids[None, :] == target.long()[:, None], scores,
                       torch.zeros((), dtype=scores.dtype, device=scores.device)).sum(1)


def local_ge_count(u, shard, tscore, target, clicked_rows, offset: int, n_valid: int,
                   bias=None):
    """[B] int32 #{rows of this shard: score >= tscore} excluding id 0,
    ids >= n_valid and the clicked ids; a tiled shard also excludes the
    target's own column by id (its score and tscore come from different
    products), the dense one counts it unless clicked (the same product)."""
    shard_n = shard.shape[0]
    if _tiled(shard_n):
        return topk_ops.tiled_ge_count(u, shard, tscore, bias=bias, clicked_rows=clicked_rows,
                                       n_valid=n_valid, col_offset=offset, target_col=target)
    scores = _dense_scores(u, shard, bias)
    gids = _gids(offset, shard_n, u.device)
    excluded = ((gids == 0) | (gids >= n_valid))[None, :] | \
        (gids[None, :, None] == clicked_rows.long()[:, None, :]).any(-1)
    return ((scores >= tscore[:, None]) & ~excluded).sum(1).to(torch.int32)


def _one_vector(u, route: str) -> None:
    if u.dim() != 2:
        raise ValueError(
            f"{route}: user vectors of shape {tuple(u.shape)}; the sharded catalog routes take "
            "one vector a user [B, d], and a multi-interest model's [B, K, d] has none yet: "
            "evaluate it with --model_parallel 1")


def sharded_catalog_topk(u, shard, k: int, mesh, clicked_rows=None, item_bias=None,
                         n_valid=None, grouped_table=None):
    """(values [B, k], GLOBAL ids [B, k]) of the catalog top-k, the same on
    every rank of the 'model' group. u [B, d] the same on the group;
    `shard` this rank's [N/m, d] block of the row-sharded table, item_bias
    its [N/m] block or None, `grouped_table` its grouped copy where the
    shard takes the tiled branch; n_valid masks the dead padded rows."""
    _one_vector(u, "sharded_catalog_topk")
    m, n_local = mesh.mp, shard.shape[0]
    offset = mesh.model_index * n_local
    nv = n_local * m if n_valid is None else n_valid
    v, gi = local_catalog_topk(u, shard, k, offset, nv, clicked_rows, item_bias, grouped_table)
    v_all = all_gather_cat(v, mesh.model_group, m, dim=1)
    i_all = all_gather_cat(gi, mesh.model_group, m, dim=1)
    return merge_topk(v_all, i_all, k)


def sharded_catalog_ranks(u, shard, target, mesh, clicked_rows, item_bias=None,
                          n_valid=None):
    """[B] int32 ground-truth catalog ranks over a row-sharded table
    (semantics of `cuda_kernels.catalog_ranks`: item 0 and the clicked
    items excluded, >= ties counting against the target, the target's own
    clicked copy re-added as the + 1)."""
    _one_vector(u, "sharded_catalog_ranks")
    m, n_local = mesh.mp, shard.shape[0]
    offset = mesh.model_index * n_local
    nv = n_local * m if n_valid is None else n_valid
    t = sum_over(local_target_score(u, shard, target, offset, item_bias), mesh.model_group, m)
    ge = local_ge_count(u, shard, t, target, clicked_rows, offset, nv, item_bias)
    return sum_over(ge, mesh.model_group, m) + 1
