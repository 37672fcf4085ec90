"""The port's catalog top-k / rank functions (rechorus_tpu_torch.ops.topk,
cuda_kernels.catalog_ranks, metrics.masked_topk) against the JAX
package's on the same numpy inputs. The JAX side takes its Pallas kernel
route (`topk.PALLAS = "on"`, interpret mode on the CPU), the route the
port always takes.

Values agree to rtol=2e-5, atol=1e-5 and ranks are equal. Ids must be
equal wherever the values are distinct: on exact f32 ties neither
`torch.topk` nor the two-level select promise an order.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu.ops import metrics as jmetrics
from rechorus_tpu.ops import pallas_kernels as PK
from rechorus_tpu.ops import topk as JT
from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.ops import metrics as tmetrics
from rechorus_tpu_torch.ops import topk as TT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_pallas_route():
    JT.PALLAS = "on"
    try:
        yield
    finally:
        JT.PALLAS = "auto"


def assert_topk_match(v_port, i_port, v_ref, i_ref):
    v_port, i_port = np.asarray(v_port), np.asarray(i_port)
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    assert v_port.shape == v_ref.shape and i_port.shape == i_ref.shape
    assert (np.isneginf(v_port) == np.isneginf(v_ref)).all()
    fin = np.isfinite(v_ref)
    np.testing.assert_allclose(v_port[fin], v_ref[fin], rtol=2e-5, atol=1e-5)
    # a value is distinct when no other value of its row lies within the
    # tolerance (which also covers 1-ulp differences between frameworks)
    with np.errstate(invalid="ignore"):         # -inf - -inf
        close = np.abs(v_ref[:, :, None] - v_ref[:, None, :]) <= 1e-5 + 2e-5 * np.abs(v_ref[:, :, None])
    distinct = fin & (close.sum(-1) == 1)
    np.testing.assert_array_equal(i_port[distinct], i_ref[distinct])


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("G,kk,fan", [
    (4000, 40, 8), (4000, 40, 16),              # below TWO_LEVEL_MIN_G
    (7001, 40, 8), (7001, 40, 16), (7001, 40, None),   # above it, ragged G
    (300, 50, 8),                               # G <= fan * kk: direct
    (30, 50, 8),                                # kk > G: narrows to G
])
def test_two_level_bucket_select_matches_jax(G, kk, fan):
    rng = np.random.default_rng(G + kk)
    bm = rng.normal(size=(6, G)).astype(np.float32)
    bm[0, 5:] = -np.inf                         # fewer than kk finite columns
    bm[1, rng.random(G) < 0.5] = -np.inf
    v_ref, i_ref = JT.two_level_bucket_select(jnp.asarray(bm), kk, fan=fan)
    v, i = TT.two_level_bucket_select(torch.from_numpy(bm), kk, fan=fan)
    assert_topk_match(v, i, v_ref, i_ref)


@pytest.mark.parametrize("G,kk,route,fits", [
    (62_592, 132, "kernel", True),      # serving at 1M items: k 100 + 32 clicked, fan 16
    (6_272, 132, "kernel", True),       # the 100k exact lane, fan 8
    (15_744, 132, "kernel", True),      # a [250001, 64] shard of the 1M table, fan 8
    (62_592, 1_100, "kernel", True),    # the runner's top-100 with 1,000 clicked ids
    (625_024, 132, "kernel", True),     # a 10M catalog: 39,064 super maxima, 157 KB
    (62_592, 3_373, "kernel", True),    # the kernel's largest kk at fan 16: 224 KB
    (62_592, 3_374, "kernel", False),   # one more: past its shared memory (CPU: plain)
    (915_456, 132, "kernel", False),    # 57,216 super maxima: past it (CPU: plain)
    (6_272, 800, "direct", False),      # G <= fan * kk (and kk past the 784 supers)
])
def test_two_level_bucket_select_routes_by_shape(monkeypatch, G, kk, route, fits):
    """`two_level_bucket_select` sends every shape with G > fan * kk to
    `bucket_select` (the D11 kernel on the card, which refuses a shape past
    `bucket_select_fits`; its plain version at any shape here), else to the
    direct `torch.topk`; both give the exact top-kk."""
    calls = []
    real = CT.bucket_select
    monkeypatch.setattr(CT, "bucket_select",
                        lambda bm, k, fan: calls.append((k, fan)) or real(bm, k, fan))
    bm = torch.randn(2, G, generator=torch.Generator().manual_seed(G + kk))
    v, i = TT.two_level_bucket_select(bm, kk)
    assert len(calls) == (route == "kernel")
    fan = TT._two_level_fan(G)
    assert (route == "kernel") == (G > fan * kk)
    assert CT.bucket_select_fits(G, kk, fan) == fits
    v_ref, i_ref = torch.topk(bm, kk, dim=1)
    assert torch.equal(v.sort(1, descending=True).values, v_ref)
    assert torch.equal(i.sort(1).values, i_ref.sort(1).values)


@pytest.mark.parametrize("G,fan", [(7_001, 8), (7_000, 12), (7_000, 24), (7_000, 0)])
def test_bucket_select_fits_only_16_byte_rows(G, fan):
    """The kernel reads rows in 16-byte loads, F / 4 threads a super: a G
    or fan that is no multiple of 4, or a fan whose F / 4 does not divide
    a warp, is outside its limits; its plain version still runs it."""
    assert not CT.bucket_select_fits(G, 40, fan)
    if fan:
        bm = torch.randn(3, G, generator=torch.Generator().manual_seed(G + fan))
        v, i = CT.bucket_select(bm, 40, fan)
        v_ref, i_ref = torch.topk(bm, 40, dim=1)
        assert torch.equal(v, v_ref) and torch.equal(i.sort(1).values, i_ref.sort(1).values)


@pytest.mark.parametrize("bucket", [16, 4])
def test_group_table_for_rescore_matches_jax(bucket):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(4197, 8)).astype(np.float32)
    ref = np.asarray(JT.group_table_for_rescore(jnp.asarray(table), bucket=bucket))
    got = TT.group_table_for_rescore(torch.from_numpy(table), bucket=bucket).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("with_bias,with_clicked,grouped,bucket,col_offset", [
    (True, True, True, 16, 0),
    (False, True, False, 16, 0),
    (True, False, False, 16, 0),
    (False, True, True, 2, 0),    # G = 8320 >= TWO_LEVEL_MIN_G: two-level select
    (True, True, True, 16, 300),  # a shard of global rows [300, 300 + N)
])
def test_tiled_catalog_topk_matches_jax(with_bias, with_clicked, grouped, bucket, col_offset):
    rng = np.random.default_rng(5)
    B, D, N, k = 8, 16, 16384 + 37, 10
    u = rng.normal(size=(B, D)).astype(np.float32)
    t = rng.normal(size=(N, D)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32) if with_bias else None
    clicked = None
    if with_clicked:
        clicked = rng.integers(0, N, size=(B, 7)).astype(np.int32)
        # knock out real winners: each row's best two items are clicked
        s = u @ t.T + (0 if bias is None else bias[None])
        clicked[:, :2] = np.argsort(-s, axis=1)[:, :2] + col_offset
    n_valid = N + col_offset - 5
    with jax_pallas_route():
        gt = JT.group_table_for_rescore(jnp.asarray(t), bucket=bucket) if grouped else None
        v_ref, i_ref = jax.jit(lambda: JT.tiled_catalog_topk(
            jnp.asarray(u), jnp.asarray(t), k, bias=_j(bias), clicked_rows=_j(clicked),
            n_valid=n_valid, bucket=bucket, col_offset=col_offset, grouped_table=gt))()
    # the port rescores from the grouped copy in every case; `grouped`
    # picks the JAX package's route, the reference
    tt = torch.from_numpy(t)
    v, i = TT.tiled_catalog_topk(
        torch.from_numpy(u), tt, k, grouped_table=TT.group_table_for_rescore(tt, bucket=bucket),
        bias=_t(bias), clicked_rows=_t(clicked), n_valid=n_valid, bucket=bucket,
        col_offset=col_offset)
    assert i.dtype == torch.int32
    assert_topk_match(v, i, v_ref, i_ref)
    if with_clicked:
        assert not (i.numpy()[:, :, None] == clicked[:, None, :2]).any()


def test_tiled_catalog_topk_rejects_approx_and_mismatched_grouped_table():
    """A grouped copy of another partition is refused by the exact lane and
    by the approx lane alike (the approx lane rescores through it too)."""
    u, t = torch.zeros(2, 4), torch.zeros(4100, 4)
    for approx in (False, True):
        with pytest.raises(ValueError, match="grouped_table"):
            TT.tiled_catalog_topk(u, t, 5, bucket=16, approx=approx,
                                  grouped_table=TT.group_table_for_rescore(t, bucket=4))


def _frozen_grouped_rescore(u, grouped, bias, gb, gv, bucket, col_offset, n_valid, n_rows):
    """The grouped rescore as tiled_catalog_topk ran it before
    `bucket_rescore` (a frozen copy): the select's bucket expansion and pad
    mask, the [B, kk, bucket, D] gather, a batched product, the masks."""
    nb = CT.NB
    base = (gb // nb) * (bucket * nb) + gb % nb
    raw_cand = (base[:, :, None] + torch.arange(bucket, dtype=gb.dtype) * nb).reshape(gb.shape[0], -1)
    raw_cand = raw_cand.masked_fill(torch.isneginf(gv).repeat_interleave(bucket, dim=1), n_rows)
    B = gb.shape[0]
    cvec = grouped[gb.clamp(max=grouped.shape[0] - 1)].view(B, -1, grouped.shape[-1])
    if u.dim() == 3:
        cs = torch.matmul(cvec, u.transpose(1, 2)).amax(-1)
    else:
        cs = torch.matmul(cvec, u[:, :, None])[:, :, 0]
    in_range = raw_cand < n_rows
    cand = raw_cand.clamp(max=n_rows - 1)
    if bias is not None:
        cs = cs + bias[cand]
    gcand = cand + col_offset
    ok = in_range & (gcand > 0)
    if n_valid is not None:
        ok &= gcand < n_valid
    return cs.masked_fill(~ok, float("-inf")), cand


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("with_bias,bucket,col_offset,nv", [
    (True, 16, 0, -5), (False, 16, 300, -5), (True, 4, 7, None), (False, 2, 0, 3)])
def test_bucket_rescore_plain_equals_the_old_grouped_rescore(K, with_bias, bucket, col_offset, nv):
    """`bucket_rescore` on CPU tensors (its plain version) gives the scores
    and ids of the gather route it replaced, bit for bit: pad slots (-inf
    maxima) among the selected buckets, the last bucket's overhang, bias,
    a shard's col_offset, n_valid below and above the table's end, K = 4."""
    rng = np.random.default_rng(26 + K + bucket)
    B, D, N, kk = 9, 12, 4197, 20
    u = torch.from_numpy(rng.normal(size=(B, K, D) if K > 1 else (B, D)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)) if with_bias else None
    grouped = TT.group_table_for_rescore(t, bucket=bucket)
    G = grouped.shape[0]
    gb = torch.from_numpy(rng.integers(0, G, size=(B, kk)))
    gb[:, 0] = G - 1                            # the last bucket: it overhangs N
    gv = torch.from_numpy(rng.normal(size=(B, kk)).astype(np.float32))
    gv[0, -6:] = float("-inf")                  # pad slots
    gv[1, :] = float("-inf")
    n_valid = None if nv is None else N + col_offset + nv
    want_s, want_c = _frozen_grouped_rescore(u, grouped, bias, gb, gv, bucket, col_offset,
                                             n_valid, N)
    before = CT.bucket_rescore.launches
    cs, cand = CT.bucket_rescore(u, grouped, gb, gv, n_rows=N, bias=bias, n_valid=n_valid,
                                 col_offset=col_offset)
    assert CT.bucket_rescore.launches == before          # the CPU runs the plain version
    assert cs.shape == cand.shape == (B, kk * bucket)
    assert torch.equal(cs, want_s) and torch.equal(cand, want_c)
    assert torch.isneginf(cs[1]).all() and torch.isneginf(cs[0, -6 * bucket:]).all()
    assert (cand[1] == N - 1).all()


# ------------------------------------------------------------ approx lane
@pytest.mark.parametrize("n,k,recall,L", [
    (62592, 132, 0.98, 7824),     # B2's G at 1M items, bucket 16: width 8
    (65536, 132, 0.98, 8192),     # a power-of-two G: width 8
    (100001, 132, 0.98, 12501),   # the dense route at 100k items: width 8
    (100001, 132, 0.90, 1563),    # m = 1243: width 64
    (62592, 132, 1.0, 62592),     # recall 1: no reduction
    (5000, 132, 0.98, 5000),      # m = 6484 >= n: no reduction
    (1000, 1, 0.95, 2),           # k = 1: m = k = 1, width 512
])
def test_approx_bins_follow_the_recall_model(n, k, recall, L):
    """L >= (k - 1) / -ln(recall) (and >= k), the width n / L rounded down to
    a power of two; computed by hand for each case."""
    assert CT.approx_bins(n, k, recall) == L


def test_plain_bin_max_equals_a_numpy_reference_with_ties():
    rng = np.random.default_rng(21)
    B, N, L = 5, 1003, 64
    x = rng.integers(-3, 4, size=(B, N)).astype(np.float32)     # many ties
    x[0, :] = -np.inf                                           # a row of -inf
    x[1, rng.random(N) < 0.7] = -np.inf
    vals, cols = CT.approx_bin_max_plain(torch.from_numpy(x), L)
    assert vals.shape == cols.shape == (B, L) and cols.dtype == torch.int32
    for b in range(B):
        for l in range(L):
            members = np.arange(l, N, L)
            best = members[np.argmax(x[b, members])]           # numpy: the first maximum
            assert cols[b, l] == best and vals[b, l] == x[b, best], (b, l)
    assert (cols[0] == torch.arange(L, dtype=torch.int32)).all()   # -inf bins: first column


@pytest.mark.parametrize("recall", [1.0, 0.95])
def test_approx_max_k_without_reduction_equals_jax_id_for_id(recall):
    """Where L = N (recall 1, or N below the bin count the model asks for)
    the select is exact: ids and values equal `lax.approx_max_k`'s."""
    rng = np.random.default_rng(22)
    x = rng.normal(size=(7, 3000)).astype(np.float32)
    k = 132
    assert CT.approx_bins(3000, k, recall) == 3000
    v_ref, i_ref = jax.lax.approx_max_k(jnp.asarray(x), k, recall_target=recall)
    v, i = TT.approx_max_k(torch.from_numpy(x), k, recall)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def _recall(ids, ref_ids):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b) for a, b in zip(ids, ref_ids)])


@pytest.mark.parametrize("recall", [0.9, 0.95, 0.98])
def test_masked_topk_approx_recall_against_jax(recall):
    """The dense approx lane reduces (L < N) and keeps its recall target
    against JAX's approx lane, which is an exact top-k on the CPU; every
    returned value is the score of its id, and no clicked id comes back."""
    rng = np.random.default_rng(23)
    B, N, M, k = 48, 40000, 8, 100
    pred = rng.normal(size=(B, N)).astype(np.float32)
    clicked = rng.integers(1, N, size=(B, M)).astype(np.int32)
    clicked[:, 0] = np.argmax(pred[:, 1:], axis=1) + 1          # the best item is clicked
    assert CT.approx_bins(N, k + M, recall) < N
    v_ref, i_ref = jmetrics.masked_topk(jnp.asarray(pred), jnp.asarray(clicked), k, n_valid=N - 3,
                                        approx=True, recall_target=recall)
    v, i = tmetrics.masked_topk(torch.from_numpy(pred), torch.from_numpy(clicked), k, n_valid=N - 3,
                                approx=True, recall_target=recall)
    i, v = i.numpy(), v.numpy()
    assert i.dtype == np.int32 and i.shape == (B, k)
    assert _recall(i, np.asarray(i_ref)) >= recall
    np.testing.assert_array_equal(v, np.take_along_axis(pred, i.astype(np.int64), 1))
    assert not (i[:, :, None] == clicked[:, None, :]).any()
    assert ((i > 0) & (i < N - 3)).all() and (np.diff(v, axis=1) <= 0).all()


@pytest.mark.parametrize("recall", [0.9, 0.98])
def test_tiled_catalog_topk_approx_recall_against_jax(recall):
    """The tiled approx lane selects its buckets approximately (L < G) and
    rescores their items exactly: recall against JAX's (exact on the CPU)
    result at least the target, every value the exact score of its id."""
    rng = np.random.default_rng(24)
    B, D, N, k, M = 12, 8, 200000, 100, 4
    u = rng.normal(size=(B, D)).astype(np.float32)
    t = rng.normal(size=(N, D)).astype(np.float32)
    clicked = rng.integers(1, N, size=(B, M)).astype(np.int32)
    tt = torch.from_numpy(t)
    G = -(-N // (16 * 128)) * 128
    assert CT.approx_bins(G, k + M, recall) < G
    v, i = TT.tiled_catalog_topk(torch.from_numpy(u), tt, k, clicked_rows=torch.from_numpy(clicked),
                                 n_valid=N, approx=True, recall_target=recall,
                                 grouped_table=TT.group_table_for_rescore(tt))
    v_ref, i_ref = jmetrics.masked_topk(jnp.asarray(u @ t.T), jnp.asarray(clicked), k, n_valid=N,
                                        approx=True, recall_target=recall)
    i, v = i.numpy(), v.numpy()
    assert _recall(i, np.asarray(i_ref)) >= recall
    exact = (u[:, None, :] * t[i.astype(np.int64)]).sum(-1)
    np.testing.assert_allclose(v, exact, rtol=1e-5, atol=1e-5)
    assert not (i[:, :, None] == clicked[:, None, :]).any()


def test_tiled_catalog_topk_approx_without_reduction_equals_jax():
    """G below the bin count the model asks for: the approx lane's bucket
    select is exact and equals the JAX package's approx lane."""
    rng = np.random.default_rng(25)
    B, D, N, k, M = 6, 8, 4100, 10, 4
    u = rng.normal(size=(B, D)).astype(np.float32)
    t = rng.normal(size=(N, D)).astype(np.float32)
    clicked = rng.integers(1, N, size=(B, M)).astype(np.int32)
    with jax_pallas_route():
        v_ref, i_ref = jax.jit(lambda: JT.tiled_catalog_topk(
            jnp.asarray(u), jnp.asarray(t), k, clicked_rows=jnp.asarray(clicked), n_valid=N,
            approx=True, recall_target=0.98))()
    tt = torch.from_numpy(t)
    v, i = TT.tiled_catalog_topk(torch.from_numpy(u), tt, k,
                                 grouped_table=TT.group_table_for_rescore(tt),
                                 clicked_rows=torch.from_numpy(clicked), n_valid=N, approx=True,
                                 recall_target=0.98)
    assert_topk_match(v, i, v_ref, i_ref)


@pytest.mark.parametrize("kind,with_bias", [("gauss", True), ("gauss", False), ("int", False)])
def test_tiled_catalog_ranks_matches_jax(kind, with_bias):
    rng = np.random.default_rng(6)
    B, D, N = 10, 16, 2600
    if kind == "int":
        u = rng.integers(-8, 9, size=(B, D)).astype(np.float32)
        t = rng.integers(-8, 9, size=(N, D)).astype(np.float32)
    else:
        u = rng.normal(size=(B, D)).astype(np.float32)
        t = rng.normal(size=(N, D)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32) if with_bias else None
    tgt = rng.integers(1, N, size=(B,)).astype(np.int32)
    clicked = rng.integers(0, N, size=(B, 6)).astype(np.int32)
    clicked[:, 0] = tgt                          # residual set holds the target
    clicked[1] = 0                               # a user with no clicks at all
    n_valid = N - 3
    with jax_pallas_route():
        ref = np.asarray(jax.jit(lambda: JT.tiled_catalog_ranks(
            jnp.asarray(u), jnp.asarray(t), jnp.asarray(tgt), jnp.asarray(clicked),
            bias=_j(bias), n_valid=n_valid))())
    got = TT.tiled_catalog_ranks(torch.from_numpy(u), torch.from_numpy(t),
                                 torch.from_numpy(tgt), torch.from_numpy(clicked),
                                 bias=_t(bias), n_valid=n_valid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["gauss", "int"])
def test_catalog_ranks_matches_jax(kind):
    rng = np.random.default_rng(7)
    B, N = 12, 3001
    if kind == "int":
        pred = rng.integers(-20, 21, size=(B, N)).astype(np.float32)
    else:
        pred = rng.normal(size=(B, N)).astype(np.float32)
    tgt = rng.integers(1, N, size=(B,)).astype(np.int32)
    clicked = np.stack([rng.choice(np.arange(1, N), size=9, replace=False) for _ in range(B)])
    clicked[:, 0] = tgt
    clicked[:, 7:] = 0                           # 0-padding
    clicked = clicked.astype(np.int32)
    ref = np.asarray(PK.catalog_ranks(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(clicked)))
    got = CK.catalog_ranks(torch.from_numpy(pred), torch.from_numpy(tgt),
                           torch.from_numpy(clicked))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_valid", [None, 2990])
def test_masked_topk_matches_jax(n_valid):
    rng = np.random.default_rng(8)
    B, N, k = 9, 3001, 20
    pred = rng.normal(size=(B, N)).astype(np.float32)
    clicked = rng.integers(0, N, size=(B, 5)).astype(np.int32)
    clicked[:, 0] = np.argmax(pred, axis=1)      # knock out each row's best
    v_ref, i_ref = jmetrics.masked_topk(jnp.asarray(pred), jnp.asarray(clicked), k,
                                        n_valid=n_valid)
    v, i = tmetrics.masked_topk(torch.from_numpy(pred), torch.from_numpy(clicked), k,
                                n_valid=n_valid)
    assert i.dtype == torch.int32
    assert_topk_match(v, i, v_ref, i_ref)


def test_gt_rank_and_topk_metrics_match_jax():
    rng = np.random.default_rng(9)
    pred = rng.integers(-3, 4, size=(50, 100)).astype(np.float32)   # many ties
    ref = np.asarray(jmetrics.gt_rank(jnp.asarray(pred)))
    got = tmetrics.gt_rank(torch.from_numpy(pred)).numpy()
    np.testing.assert_array_equal(got, ref)
    topk, metrics = [1, 5, 10, 50], ["HR", "NDCG"]
    assert tmetrics.evaluate_topk_from_ranks(got, topk, metrics) == \
        jmetrics.evaluate_topk_from_ranks(ref, topk, metrics)
