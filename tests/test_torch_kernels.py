"""Plain versions of the port's catalog kernels (rechorus_tpu_torch.ops.
cuda_kernels / cuda_topk) against the JAX Pallas kernels they replace,
run in interpret mode on the CPU. Inputs are made with numpy from a seed
and handed to both.

Integer-valued inputs (entries in [-8, 8]) make every f32 partial sum
exact in any order, so counts and maxima must be EQUAL; they also tie
often, which exercises the >= tie rule. On Gaussian inputs two summation
orders may differ by an ulp, so a count may differ only through columns
whose float64 score lies within 1e-6 (relative) of the target score, and
bucket maxima agree to atol=1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu.ops import pallas_kernels as PK
from rechorus_tpu.ops import pallas_topk as PT
from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_topk as CT

from test_torch_cuda_kernels import SHAPES

NEAR_TIE_RTOL = 1e-6


def _inputs(rng, kind, *shape):
    if kind == "int":
        return rng.integers(-8, 9, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _scores64(u, t, bias):
    s = u.astype(np.float64) @ t.astype(np.float64).T
    if bias is not None:
        s = s + bias.astype(np.float64)[None]
    return s


def _near_ties(s64, tscore, ok):
    """[B] count of unmasked columns within the near-tie band of tscore."""
    ts = tscore.astype(np.float64)[:, None]
    return ((np.abs(s64 - ts) <= NEAR_TIE_RTOL * np.maximum(np.abs(ts), 1e-30)) & ok).sum(1)


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_ge_count_matches_pallas(kind):
    rng = np.random.default_rng(1)
    B, N = 13, 2999                          # ragged rows and columns
    pred = _inputs(rng, kind, B, N)
    target = pred[np.arange(B), rng.integers(0, N, size=B)]   # ties on purpose
    ref = np.asarray(PK.ge_count(jnp.asarray(pred), jnp.asarray(target)))
    got = CK.ge_count(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind,with_bias,col_offset,n_valid_delta", [
    ("int", True, 0, -37),
    ("int", False, 100, 60),
    ("gauss", True, 0, -37),
    ("gauss", False, 100, 60),
])
def test_fused_bucket_max_matches_pallas(kind, with_bias, col_offset, n_valid_delta):
    rng = np.random.default_rng(2)
    B, D, N, bucket = 12, 24, 4197, 4        # odd N: block overhang
    u, t = _inputs(rng, kind, B, D), _inputs(rng, kind, N, D)
    bias = _inputs(rng, kind, N) if with_bias else None
    n_valid = N + col_offset + n_valid_delta
    ref = np.asarray(PT.fused_bucket_max(
        jnp.asarray(u), jnp.asarray(t), bucket=bucket,
        bias=None if bias is None else jnp.asarray(bias), n_valid=n_valid,
        col_offset=jnp.int32(col_offset), tb=8))
    got = CT.fused_bucket_max(
        torch.from_numpy(u), torch.from_numpy(t), bucket=bucket,
        bias=None if bias is None else torch.from_numpy(bias), n_valid=n_valid,
        col_offset=col_offset).numpy()
    assert got.shape == ref.shape == (B, -(-N // (bucket * 128)) * 128)
    assert (np.isinf(got) == np.isinf(ref)).all()
    fin = np.isfinite(ref)
    if kind == "int":
        np.testing.assert_array_equal(got[fin], ref[fin])
    else:
        np.testing.assert_allclose(got[fin], ref[fin], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,with_bias,with_target,col_offset", [
    ("int", True, True, 0),
    ("int", False, True, 1300),
    ("int", True, False, 0),
    ("gauss", True, True, 0),
    ("gauss", False, True, 1300),
])
def test_fused_ge_count_matches_pallas(kind, with_bias, with_target, col_offset):
    rng = np.random.default_rng(3)
    B, D, N = 11, 24, 1541
    u, t = _inputs(rng, kind, B, D), _inputs(rng, kind, N, D)
    bias = _inputs(rng, kind, N) if with_bias else None
    n_valid = col_offset + N - 11
    tgt_local = rng.integers(1, N - 11, size=B)
    s64 = _scores64(u, t, bias)
    tscore = s64[np.arange(B), tgt_local].astype(np.float32)
    tgt = (tgt_local + col_offset).astype(np.int32)
    ref = np.asarray(PT.fused_ge_count(
        jnp.asarray(u), jnp.asarray(t), jnp.asarray(tscore),
        target_col=jnp.asarray(tgt) if with_target else None,
        bias=None if bias is None else jnp.asarray(bias), n_valid=n_valid,
        col_offset=jnp.int32(col_offset), tn=512, tb=8))
    got = CT.fused_ge_count(
        torch.from_numpy(u), torch.from_numpy(t), torch.from_numpy(tscore),
        target_col=torch.from_numpy(tgt) if with_target else None,
        bias=None if bias is None else torch.from_numpy(bias), n_valid=n_valid,
        col_offset=col_offset).numpy()
    assert got.dtype == np.int32
    if kind == "int":
        np.testing.assert_array_equal(got, ref)
    else:
        gid = np.arange(N) + col_offset
        ok = ((gid > 0) & (gid < n_valid))[None] & (gid[None] != tgt[:, None])
        assert (np.abs(got.astype(np.int64) - ref) <= _near_ties(s64, tscore, ok)).all()


@pytest.mark.parametrize("B,N,D,bucket,with_bias,off,nv", SHAPES)
def test_fused_plain_versions_match_pallas_at_tile_edges(B, N, D, bucket, with_bias, off, nv):
    """The shapes the card-only tests give the CUDA kernels (B, N and D on
    and around the tile, chunk, block and stage sizes), on integer inputs:
    the plain versions equal the Pallas kernels exactly."""
    rng = np.random.default_rng(B + N + D)
    u, t = _inputs(rng, "int", B, D), _inputs(rng, "int", N, D)
    bias = _inputs(rng, "int", N) if with_bias else None
    n_valid = None if nv is None else N + off + nv
    j_bias = None if bias is None else jnp.asarray(bias)
    t_bias = None if bias is None else torch.from_numpy(bias)
    ref = np.asarray(PT.fused_bucket_max(jnp.asarray(u), jnp.asarray(t), bucket=bucket, bias=j_bias,
                                         n_valid=n_valid, col_offset=jnp.int32(off)))
    got = CT.fused_bucket_max(torch.from_numpy(u), torch.from_numpy(t), bucket=bucket,
                              bias=t_bias, n_valid=n_valid, col_offset=off).numpy()
    np.testing.assert_array_equal(got, ref)

    tgt = rng.integers(0, N, size=B)
    tscore = _scores64(u, t, bias)[np.arange(B), tgt].astype(np.float32)
    tcol = (tgt + off).astype(np.int32)
    ref = np.asarray(PT.fused_ge_count(jnp.asarray(u), jnp.asarray(t), jnp.asarray(tscore),
                                       target_col=jnp.asarray(tcol), bias=j_bias,
                                       n_valid=n_valid, col_offset=jnp.int32(off)))
    got = CT.fused_ge_count(torch.from_numpy(u), torch.from_numpy(t), torch.from_numpy(tscore),
                            target_col=torch.from_numpy(tcol), bias=t_bias, n_valid=n_valid,
                            col_offset=off).numpy()
    np.testing.assert_array_equal(got, ref)


def test_expand_bucket_items_inverts_partition():
    N, bucket = 4197, 4
    G = -(-N // (bucket * 128)) * 128
    gb = torch.arange(G)[None]
    items = CT.expand_bucket_items(gb, bucket)[0].numpy()
    assert sorted(items[items < N].tolist()) == list(range(N))
    ref = np.asarray(PT.expand_bucket_items(jnp.arange(G, dtype=jnp.int32)[None], bucket))[0]
    np.testing.assert_array_equal(items, ref)


def test_kernel_wrappers_refuse_non_cuda_devices():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        CK.ge_count(meta, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        CT.fused_bucket_max(meta, torch.empty(16, 8, device="meta"), bucket=2)
    with pytest.raises(ValueError, match="no kernel"):
        CT.fused_ge_count(meta, torch.empty(16, 8, device="meta"), torch.empty(4, device="meta"))
