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
  For a multi-interest model, u [B, K, D], a row's score is the max over
  the K interests, taken before the compare (the count of a max is no
  function of the K counts); one kernel body serves every K.

`bucket_select` -- stage 2 of the exact top-k: each row's kk largest
  bucket maxima of `fused_bucket_max`'s output, by the contiguous two-level
  select (super maxima, then their winners' members), in one launch.

`bucket_rescore` -- stage 3 of the exact top-k: every item of each user's
  selected buckets scored again, straight from the grouped copy
  (`topk.group_table_for_rescore`), with the id masks, in B2's order of
  summation, so a score equals the one its bucket maximum was taken over.

`approx_bin_max` -- the first stage of the approximate top-k
  (`ops.topk.approx_max_k`): per row, the maximum and its column over
  each of L strided bins (column j in bin j mod L), L from the recall
  model of `approx_bins`. It replaces the PartialReduce of the TPU's
  `jax.lax.approx_max_k`, an XLA primitive rather than a Pallas kernel.

Masks live in GLOBAL id space: global id = local row + `col_offset`.
On CUDA tensors the wrappers launch `rtt_bucket_max_kernel` /
`rtt_fused_ge_kernel` (`rtt_interest_ge_kernel` at K > 1) /
`rtt_bucket_select_kernel` / `rtt_bucket_rescore_kernel` /
`rtt_approx_bin_max_kernel`
(csrc/catalog_kernels.cu); on CPU tensors they run the `*_plain`
versions, which materialize the masked scores.
"""
from __future__ import annotations

import math

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
        _build.launchers.rtt_fused_bucket_max(
            u.get_device(), _build.ptr(u), _build.ptr(table), _build.ptr(bias), _build.ptr(out),
            B, N, D, int(bucket), n_valid_c, int(col_offset))
        fused_bucket_max.launches += 1
    return out


fused_bucket_max.launches = 0


# shared memory `rtt_bucket_select_kernel` keeps a row's keys in: its
# ceil(G / F) super maxima, later its kk * F candidates, and kk super ids
# (up to the 227 KB a block may use on sm_90, less its static scratch)
SELECT_SMEM_BYTES = 224 * 1024


def bucket_select_fits(G: int, kk: int, fan: int) -> bool:
    """Whether `bucket_select`'s kernel takes [B, G] maxima at kk and fan F:
    rows read in 16-byte loads (G % 4 == 0; F % 4 == 0 with F / 4 dividing
    32), kk at most ceil(G / F) supers, and 4 * (max(ceil(G / F), kk * F),
    rounded up to 4, + kk) bytes of keys within SELECT_SMEM_BYTES (G up to
    915,392 at F 16 and kk 132; kk up to 3,373 at G 62,592 and F 16)."""
    if G % 4 or fan <= 0 or fan % 4 or 32 % (fan // 4):
        return False
    S = _cdiv(G, fan)
    return 1 <= kk <= S and 4 * (_cdiv(max(S, kk * fan), 4) * 4 + kk) <= SELECT_SMEM_BYTES


def bucket_select_plain(bm: torch.Tensor, kk: int, fan: int):
    """`bucket_select` as PyTorch ops: pad G to a multiple of F with -inf,
    top-kk of the [B, S] super maxima, gather the winners' F contiguous
    members, top-kk of those. Values descending."""
    B, G = bm.shape
    pad = (-G) % fan
    if pad:
        bm = F.pad(bm, (0, pad), value=float("-inf"))
    mem = bm.view(B, -1, fan)                                          # [B, S, F]
    _, sb = torch.topk(mem.amax(-1), kk, dim=1)                        # [B, kk]
    rows = mem.gather(1, sb[:, :, None].expand(B, kk, fan))            # [B, kk, F]
    gb_all = sb[:, :, None] * fan + torch.arange(fan, device=bm.device)
    v, sel = torch.topk(rows.reshape(B, -1), kk, dim=1)
    return v, gb_all.reshape(B, -1).gather(1, sel)


def bucket_select(bm: torch.Tensor, kk: int, fan: int):
    """(values [B, kk] float32, column ids [B, kk] int64): the kk largest of
    each row of bm [B, G] float32 (B2's bucket maxima), exact, by the
    contiguous two-level select with super-buckets of `fan` columns. Each
    value is bm at its id bit for bit. The kk come back in no particular
    order: first those above the kk-th value, then its ties; which of
    several exactly tied columns at the kk boundary is taken may differ
    from `torch.topk`'s choice. A row with fewer than kk finite columns
    fills with -inf ones. Ids lie in [0, G).

    Kernel on CUDA tensors: a 16-byte aligned bm within
    `bucket_select_fits`, else ValueError. Plain on CPU ones, at any shape,
    values descending."""
    if bm.device.type == "cpu":
        return bucket_select_plain(bm, kk, fan)
    if bm.device.type != "cuda":
        raise ValueError(f"bucket_select: no kernel for device {bm.device}")
    B, G = bm.shape
    _build.check_input("bucket_select", "bm", bm, torch.float32, (B, G), bm.device)
    if not bucket_select_fits(G, kk, fan):
        raise ValueError(f"bucket_select: G={G}, kk={kk}, fan={fan} outside the kernel's "
                         f"limits (G and fan multiples of 4, fan / 4 dividing 32, "
                         f"kk <= ceil(G / fan), keys within {SELECT_SMEM_BYTES} bytes)")
    if bm.data_ptr() % 16:
        raise ValueError("bucket_select: bm must be 16-byte aligned")
    _build.check_int32("bucket_select", B=B, G=G)
    gv = torch.empty(B, kk, dtype=torch.float32, device=bm.device)
    gb = torch.empty(B, kk, dtype=torch.int64, device=bm.device)
    if B:
        _build.launchers.rtt_bucket_select(bm.get_device(), bm.data_ptr(), gv.data_ptr(),
                                           gb.data_ptr(), B, G, int(fan), int(kk))
        bucket_select.launches += 1
    return gv, gb


bucket_select.launches = 0


def expand_bucket_items(gb: torch.Tensor, bucket: int, nb: int = NB) -> torch.Tensor:
    """Strided-bucket ids [B, kk] -> candidate LOCAL item ids [B, kk*bucket]
    (the stage-2 counterpart of `fused_bucket_max`'s partition)."""
    base = (gb // nb) * (bucket * nb) + gb % nb
    items = base[:, :, None] + (torch.arange(bucket, dtype=gb.dtype, device=gb.device) * nb)
    return items.reshape(gb.shape[0], -1)


def selected_items(gb: torch.Tensor, gv: torch.Tensor, bucket: int, n_rows: int) -> torch.Tensor:
    """Candidate LOCAL item ids [B, kk*bucket] of the selected buckets gb
    [B, kk] whose maxima are gv. A -inf maximum marks a pad slot (fewer
    than kk finite buckets): the strided expansion can alias it onto REAL
    items, so its ids are n_rows, out of range, for `mask_candidates`."""
    pad = torch.isneginf(gv).repeat_interleave(bucket, dim=1)
    return expand_bucket_items(gb, bucket).masked_fill(pad, n_rows)


def row_scores(u, vecs):
    """[B, M] scores of each row's own vectors vecs [B, M, D]: u [B, D]
    dotted with them, or for K interests u [B, K, D] the max over k."""
    if u.dim() == 3:
        return torch.matmul(vecs, u.transpose(1, 2)).amax(-1)
    return torch.matmul(vecs, u[:, :, None])[:, :, 0]


def mask_candidates(cs, raw_cand, bias, col_offset, n_valid, n_rows):
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


def bucket_rescore_plain(u, grouped, gb, gv, *, n_rows: int, bias=None, n_valid=None,
                         col_offset: int = 0):
    """`bucket_rescore` by a gather of the [B, kk, bucket, D] slices and a
    batched product."""
    B = gb.shape[0]
    bucket, D = grouped.shape[1], grouped.shape[2]
    raw_cand = selected_items(gb, gv, bucket, n_rows)
    cvec = grouped[gb.clamp(max=grouped.shape[0] - 1)]                  # [B, kk, bucket, D]
    cs = row_scores(u, cvec.view(B, -1, D))
    return mask_candidates(cs, raw_cand, bias, col_offset, n_valid, n_rows)


def bucket_rescore(u, grouped, gb, gv, *, n_rows: int, bias=None, n_valid=None,
                   col_offset: int = 0):
    """(scores [B, kk*bucket] float32, LOCAL ids [B, kk*bucket] int64) of
    every item of the selected buckets gb [B, kk] (int64 ids of
    `fused_bucket_max`'s partition; gv [B, kk] float32 their maxima, -inf
    marking a pad slot), read from grouped [Gp, bucket, D], the grouped copy
    of a table of n_rows rows (`topk.group_table_for_rescore`). A score is
    u[b] . row (+ bias[row]), or for u [B, K, D] (K <= 8) the max over k,
    summed as B2 sums it (fmaf over d upwards, then + bias). Slot j of
    selected bucket i is column i*bucket + j, its id
    `expand_bucket_items(gb, bucket)` there. A slot scores -inf past n_rows
    (the last bucket's overhang, whose id is clamped to n_rows - 1), in a
    pad slot (id n_rows - 1), and at a global id (id + col_offset) <= 0 or
    >= n_valid."""
    if u.device.type == "cpu":
        return bucket_rescore_plain(u, grouped, gb, gv, n_rows=n_rows, bias=bias,
                                    n_valid=n_valid, col_offset=col_offset)
    if u.device.type != "cuda":
        raise ValueError(f"bucket_rescore: no kernel for device {u.device}")
    if u.dim() not in (2, 3):
        raise ValueError(f"bucket_rescore: u has shape {tuple(u.shape)}, expected [B, D] or "
                         "[B, K, D]")
    (B, kk), (Gp, bucket, D), dev = gb.shape, grouped.shape, u.device
    K = u.shape[1] if u.dim() == 3 else 1
    _build.check_input("bucket_rescore", "u", u, torch.float32,
                       (B, K, D) if u.dim() == 3 else (B, D), dev)
    _build.check_input("bucket_rescore", "grouped", grouped, torch.float32, (Gp, bucket, D), dev)
    _build.check_input("bucket_rescore", "gb", gb, torch.int64, (B, kk), dev)
    _build.check_input("bucket_rescore", "gv", gv, torch.float32, (B, kk), dev)
    if bias is not None:
        _build.check_input("bucket_rescore", "bias", bias, torch.float32, (n_rows,), dev)
    if not 1 <= K <= INTEREST_KS[-1] or D < 1 or not 1 <= n_rows <= Gp * bucket:
        raise ValueError(f"bucket_rescore: K={K} (at most {INTEREST_KS[-1]}), D={D}, "
                         f"n_rows={n_rows} over a grouped copy of {Gp} x {bucket} rows")
    n_valid_c = -1 if n_valid is None else int(n_valid)
    _build.check_int32("bucket_rescore", Gp=Gp, D=D, n_rows=n_rows, n_valid=n_valid_c,
                       col_offset=int(col_offset), slots=B * kk * bucket)
    cs = torch.empty(B, kk * bucket, dtype=torch.float32, device=dev)
    cand = torch.empty(B, kk * bucket, dtype=torch.int64, device=dev)
    if B and kk:
        _build.launchers.rtt_bucket_rescore(
            u.get_device(), _build.ptr(u), _build.ptr(grouped), _build.ptr(gb), _build.ptr(gv),
            _build.ptr(bias), _build.ptr(cs), _build.ptr(cand), B, K, kk, Gp, bucket, D, n_rows,
            n_valid_c, int(col_offset))
        bucket_rescore.launches += 1
    return cs, cand


bucket_rescore.launches = 0


# interest counts the rank count holds in one thread's 8 rows
INTEREST_KS = (1, 2, 4, 8)
# score elements a block of the plain multi-interest count materializes
_PLAIN_BLOCK_ELEMS = 1 << 26


def interest_width(K: int) -> int:
    """The K' in INTEREST_KS that `interest_rows` widens K interests to:
    the least one at or above K. Raises above 8."""
    for kk in INTEREST_KS:
        if K <= kk:
            return kk
    raise ValueError(f"fused_ge_count: K={K} interests; the kernel holds at most "
                     f"{INTEREST_KS[-1]} a user (one thread's 8 rows of the score tile)")


def interest_rows(u: torch.Tensor) -> torch.Tensor:
    """[rows, D] contiguous interest rows of u [B, K, D] as
    `rtt_interest_ge_kernel` reads them. K outside INTEREST_KS is widened
    to `interest_width(K)` by repeating interest 0, which leaves every max
    as it is. K' <= 4: user-major, rows = B * K'. K' = 8: each 16 users'
    128 rows ordered (4 user quads, 2 halves, 4 users, 4 interests), so
    that a thread's rows {r..r+3, r+16..r+19} are one user's 8; B padded to
    a multiple of 16 with zero users, rows = 128 * ceil(B / 16)."""
    B, K, D = u.shape
    kk = interest_width(K)
    if kk != K:
        u = torch.cat([u, u[:, :1].expand(B, kk - K, D)], dim=1)
    if kk < 8:
        return u.reshape(B * kk, D).contiguous()
    pad = (-B) % 16
    if pad:
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
    return u.view(-1, 4, 4, 2, 4, D).permute(0, 1, 3, 2, 4, 5).reshape(-1, D).contiguous()


def interest_scores(u, table, bias=None) -> torch.Tensor:
    """[B, N] max_k u[:, k] . table.T (+ bias) of u [B, K, D]."""
    B, K, D = u.shape
    s = (u.reshape(B * K, D) @ table.T).view(B, K, -1).amax(1)
    if bias is not None:
        s += bias[None, :]
    return s


def fused_ge_count_plain(u, table, tscore, *, target_col=None, bias=None, n_valid=None,
                         col_offset: int = 0) -> torch.Tensor:
    """[B] int32 `#{row r: score(b, r) >= tscore[b]}` over rows passing the
    id masks, from the materialized scores: one [B, N] product for u
    [B, D], `interest_scores` in blocks of users for u [B, K, D]."""
    B, N = u.shape[0], table.shape[0]
    ok = _row_ok(N, n_valid, col_offset, u.device)
    gid = torch.arange(N, device=u.device) + col_offset
    step = max(1, B if u.dim() == 2 else _PLAIN_BLOCK_ELEMS // max(1, u.shape[1] * N))
    out = []
    for lo in range(0, B, step):
        ub = u[lo: lo + step]
        s = _scores(ub, table, bias) if u.dim() == 2 else interest_scores(ub, table, bias)
        ge = (s >= tscore[lo: lo + step, None]) & ok[None, :]
        if target_col is not None:
            ge &= gid[None, :] != target_col[lo: lo + step, None]
        out.append(ge.sum(1))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=u.device)
    return torch.cat(out).to(torch.int32)


def fused_ge_count(u, table, tscore, *, target_col=None, bias=None, n_valid=None,
                   col_offset: int = 0) -> torch.Tensor:
    """[B] int32 counts of `#{row r: score(b, r) >= tscore[b]}` over rows
    passing the id masks (global id > 0, < n_valid, != target_col[b]),
    score = u @ table.T (+ bias) for u [B, D], or for a multi-interest
    model's u [B, K, D] (K <= 8) the max over k of u[:, k] @ table.T (+
    bias). table [N, D], tscore [B], bias [N] float32; target_col [B]
    int32. [B, 1, D] counts what [B, D] counts, in the same kernel."""
    if u.dim() not in (2, 3):
        raise ValueError(f"fused_ge_count: u has shape {tuple(u.shape)}, expected [B, D] or "
                         "[B, K, D]")
    if u.device.type == "cpu":
        return fused_ge_count_plain(u, table, tscore, target_col=target_col, bias=bias,
                                    n_valid=n_valid, col_offset=col_offset)
    if u.device.type != "cuda":
        raise ValueError(f"fused_ge_count: no kernel for device {u.device}")
    B, D, N, dev = u.shape[0], u.shape[-1], table.shape[0], u.device
    K = u.shape[1] if u.dim() == 3 else 1
    _build.check_input("fused_ge_count", "u", u, torch.float32,
                       (B, K, D) if u.dim() == 3 else (B, D), dev)
    _build.check_input("fused_ge_count", "table", table, torch.float32, (N, D), dev)
    _build.check_input("fused_ge_count", "tscore", tscore, torch.float32, (B,), dev)
    if target_col is not None:
        _build.check_input("fused_ge_count", "target_col", target_col, torch.int32, (B,), dev)
    if bias is not None:
        _build.check_input("fused_ge_count", "bias", bias, torch.float32, (N,), dev)
    if D < 1 or K < 1:
        raise ValueError(f"fused_ge_count: K={K}, D={D}")
    rows = interest_rows(u) if u.dim() == 3 else u
    n_valid_c = -1 if n_valid is None else int(n_valid)
    _build.check_int32("fused_ge_count", B=B, rows=rows.shape[0], N=N, D=D, n_valid=n_valid_c,
                       col_offset=int(col_offset))
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    if B and N:
        _build.launchers.rtt_fused_ge_count(
            u.get_device(), _build.ptr(rows), _build.ptr(table), _build.ptr(tscore),
            _build.ptr(target_col), _build.ptr(bias), _build.ptr(counts), B, interest_width(K),
            rows.shape[0], N, D, n_valid_c, int(col_offset))
        fused_ge_count.launches += 1
    return counts


fused_ge_count.launches = 0


def approx_bins(n: int, k: int, recall_target: float) -> int:
    """The number of strided bins L that an approximate top-k of k out of
    n columns at `recall_target` reduces to, by the recall model of the
    TPU's PartialReduce (Chern et al. 2022, arXiv 2206.14286; XLA's
    ApproxTopK sizing): a top-k element is lost only when another one
    shares its bin, so the expected recall is ((L - 1) / L)^(k - 1) and
    L >= (k - 1) / -ln(recall_target) suffices, and at least k. The bin
    width n / L is rounded down to a power of two. L = n (no reduction,
    an exact top-k) at recall_target 1 or where the width would be 1."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target={recall_target} outside (0, 1]")
    if recall_target == 1.0 or n <= k:
        return n
    m = max(k, int((k - 1) / -math.log(recall_target)))
    if m >= n:
        return n
    width = 1 << ((n // m).bit_length() - 1)
    return _cdiv(n, width)


def approx_bin_max_plain(x: torch.Tensor, L: int):
    """([B, L] maxima, [B, L] int32 columns) over the strided bins of x [B, N]
    (column j in bin j mod L); ties go to the lowest column, -inf bins keep
    their first column. The columns pad to a multiple of L with -inf, which
    never wins: the first column of every bin is a real one."""
    B, N = x.shape
    W = _cdiv(N, L)
    xw = F.pad(x, (0, W * L - N), value=float("-inf")).view(B, W, L)
    vals = xw.amax(1)
    step = torch.arange(W, dtype=torch.int32, device=x.device)[None, :, None]
    w = torch.where(xw == vals[:, None, :], step, W).amin(1)
    cols = w * L + torch.arange(L, dtype=torch.int32, device=x.device)[None, :]
    return vals, cols


def approx_bin_max(x: torch.Tensor, L: int):
    """([B, L] float32 maxima, [B, L] int32 columns) of the strided bins of
    x [B, N] float32 (column j in bin j mod L, 1 <= L <= N): the bin max of
    `ops.topk.approx_max_k`. Kernel on CUDA tensors, plain on CPU ones."""
    if x.device.type == "cpu":
        return approx_bin_max_plain(x, L)
    if x.device.type != "cuda":
        raise ValueError(f"approx_bin_max: no kernel for device {x.device}")
    B, N = x.shape
    _build.check_input("approx_bin_max", "x", x, torch.float32, (B, N), x.device)
    if not 1 <= L <= max(N, 1):
        raise ValueError(f"approx_bin_max: L={L} outside [1, N={N}]")
    _build.check_int32("approx_bin_max", B=B, N=N, L=L)
    vals = torch.empty(B, L, dtype=torch.float32, device=x.device)
    cols = torch.empty(B, L, dtype=torch.int32, device=x.device)
    if B and N:
        _build.launchers.rtt_approx_bin_max(x.get_device(), x.data_ptr(), vals.data_ptr(),
                                            cols.data_ptr(), B, N, L)
        approx_bin_max.launches += 1
    return vals, cols


approx_bin_max.launches = 0
