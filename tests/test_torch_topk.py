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
from rechorus_tpu_torch.ops import metrics as tmetrics
from rechorus_tpu_torch.ops import topk as TT


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
    tt = torch.from_numpy(t)
    v, i = TT.tiled_catalog_topk(
        torch.from_numpy(u), tt, k, bias=_t(bias), clicked_rows=_t(clicked),
        n_valid=n_valid, bucket=bucket, col_offset=col_offset,
        grouped_table=TT.group_table_for_rescore(tt, bucket=bucket) if grouped else None)
    assert i.dtype == torch.int32
    assert_topk_match(v, i, v_ref, i_ref)
    if with_clicked:
        assert not (i.numpy()[:, :, None] == clicked[:, None, :2]).any()


def test_tiled_catalog_topk_rejects_approx_and_mismatched_grouped_table():
    u, t = torch.zeros(2, 4), torch.zeros(4100, 4)
    with pytest.raises(NotImplementedError, match="approx"):
        TT.tiled_catalog_topk(u, t, 5, approx=True)
    with pytest.raises(ValueError, match="grouped_table"):
        TT.tiled_catalog_topk(u, t, 5, bucket=16,
                              grouped_table=TT.group_table_for_rescore(t, bucket=4))


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
