"""The port's CUDA kernels against their plain versions ON THE CARD, at
ragged shapes chip_smoke.py does not reach (B, N and D off the tile
sizes, D below and above one 64-dim stage, bias, col_offset, n_valid).
Integer-valued inputs make every f32 sum exact, so results must be equal.

Marked `cuda`; each test skips without a CUDA device. On the GPU machine
these tests need none of the JAX set-up of tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_scatter as CS
from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.ops import topk as TT
from rechorus_tpu_torch.serve import ServeIndex

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(gen, *shape, lo=-8, hi=9):
    return torch.randint(lo, hi, shape, generator=gen).float()


@pytest.mark.parametrize("B,N", [(1, 1), (3, 4095), (7, 4097), (300, 9001)])
def test_ge_count_kernel_equals_plain(dev, B, N):
    gen = torch.Generator().manual_seed(B * N)
    pred = _ints(gen, B, N)
    target = pred[torch.arange(B), torch.randint(0, N, (B,), generator=gen)]
    before = CK.ge_count.launches
    got = CK.ge_count(pred.to(dev), target.to(dev))
    assert CK.ge_count.launches == before + 1
    torch.testing.assert_close(got.cpu(), CK.ge_count_plain(pred, target), rtol=0, atol=0)


SHAPES = [  # B, N, D, bucket, bias, col_offset, n_valid offset from N + col_offset
    (1, 1, 1, 16, False, 0, None),
    (5, 300, 24, 4, True, 0, -3),
    (70, 4197, 64, 16, False, 7, -40),
    (130, 2049, 100, 2, True, 0, 5),
    (64, 16421, 33, 16, True, 1300, -1),
    # the 128 x 128 tile's edges: B around one and two user tiles, N one row
    # before, on and after a chunk (128) and a block (bucket * 128) boundary,
    # D below, on and above one 64-dim stage, bucket 1
    (127, 127, 4, 1, False, 0, None),
    (128, 128, 60, 1, True, 0, -1),
    (129, 129, 64, 1, False, 3, None),
    (5, 511, 64, 4, True, 0, -2),
    (9, 512, 64, 4, False, 0, None),
    (3, 513, 64, 4, True, 2, 1),
    (257, 2047, 68, 16, True, 0, -5),
    (128, 2048, 128, 16, False, 0, None),
    (129, 2049, 130, 16, True, 11, 2),
    (64, 20481, 64, 16, True, 0, -1),
    # D above what lets the user tile stay resident: its slabs ride the ring
    (130, 700, 320, 3, False, 5, None),
    (3, 1000, 400, 2, True, 0, -7),
]


@pytest.mark.parametrize("B,N,D,bucket,with_bias,off,nv", SHAPES)
def test_fused_kernels_equal_plain(dev, B, N, D, bucket, with_bias, off, nv):
    gen = torch.Generator().manual_seed(B + N + D)
    u, t = _ints(gen, B, D), _ints(gen, N, D)
    bias = _ints(gen, N) if with_bias else None
    n_valid = None if nv is None else N + off + nv
    kw = dict(bias=bias, n_valid=n_valid, col_offset=off)
    kw_dev = dict(kw, bias=None if bias is None else bias.to(dev))
    bm = CT.fused_bucket_max(u.to(dev), t.to(dev), bucket=bucket, **kw_dev)
    torch.testing.assert_close(bm.cpu(), CT.fused_bucket_max_plain(u, t, bucket=bucket, **kw),
                               rtol=0, atol=0)

    s = u @ t.T + (0 if bias is None else bias)
    tgt = torch.randint(0, N, (B,), generator=gen)
    tscore = s[torch.arange(B), tgt].contiguous()
    tcol = (tgt + off).to(torch.int32)
    for target_col in (tcol, None):
        got = CT.fused_ge_count(u.to(dev), t.to(dev), tscore.to(dev),
                                target_col=None if target_col is None else target_col.to(dev),
                                **kw_dev)
        ref = CT.fused_ge_count_plain(u, t, tscore, target_col=target_col, **kw)
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)


def test_wrappers_check_their_inputs(dev):
    u, t = torch.zeros(4, 8, device=dev), torch.zeros(300, 8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        CT.fused_bucket_max(u.double(), t.double(), bucket=2)
    with pytest.raises(ValueError, match="contiguous"):
        CT.fused_bucket_max(u, torch.zeros(8, 300, device=dev).T, bucket=2)
    with pytest.raises(ValueError, match="is on"):
        CT.fused_ge_count(u, t, torch.zeros(4))
    with pytest.raises(TypeError, match="dtype"):
        CT.fused_ge_count(u, t, torch.zeros(4, device=dev),
                          target_col=torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="shape"):
        CK.ge_count(torch.zeros(4, 9, device=dev), torch.zeros(5, device=dev))


def test_tiled_topk_and_ranks_on_card_match_cpu(dev):
    rng = np.random.default_rng(12)
    B, N, D, k = 37, 16384 + 37, 24, 50
    u = torch.from_numpy(rng.integers(-8, 9, size=(B, D)).astype(np.float32))
    t = torch.from_numpy(rng.integers(-8, 9, size=(N, D)).astype(np.float32))
    clicked = torch.from_numpy(rng.integers(0, N, size=(B, 9)).astype(np.int32))
    tgt = torch.from_numpy(rng.integers(1, N, size=(B,)).astype(np.int32))
    clicked[:, 0] = tgt
    grouped = TT.group_table_for_rescore(t)
    v_c, i_c = TT.tiled_catalog_topk(u, t, k, clicked_rows=clicked, n_valid=N - 3,
                                     grouped_table=grouped)
    v_g, i_g = TT.tiled_catalog_topk(u.to(dev), t.to(dev), k, clicked_rows=clicked.to(dev),
                                     n_valid=N - 3, grouped_table=grouped.to(dev))
    torch.testing.assert_close(v_g.cpu(), v_c, rtol=0, atol=0)   # integer scores: exact
    r_c = TT.tiled_catalog_ranks(u, t, tgt, clicked, n_valid=N - 3)
    r_g = TT.tiled_catalog_ranks(u.to(dev), t.to(dev), tgt.to(dev), clicked.to(dev),
                                 n_valid=N - 3)
    torch.testing.assert_close(r_g.cpu(), r_c, rtol=0, atol=0)


def test_serve_index_defaults_to_the_card(dev):
    rng = np.random.default_rng(13)
    u_table = rng.normal(size=(20, 8)).astype(np.float32)
    i_table = rng.normal(size=(16384 + 5, 8)).astype(np.float32)
    idx = ServeIndex.from_tables(u_table, i_table, k=10)
    assert idx.i_table.device.type == "cuda" and idx.grouped is not None
    before = CT.fused_bucket_max.launches
    items, scores = idx.query(np.arange(1, 9))
    assert CT.fused_bucket_max.launches == before + 1
    ref = ServeIndex.from_tables(u_table, i_table, k=10, device="cpu").query(np.arange(1, 9))
    np.testing.assert_allclose(scores, ref[1], rtol=2e-5, atol=1e-5)


# N, W, dtype, R: row bytes that take the 16-, 4-, 2- and 1-byte unit paths
SCATTER_SHAPES = [(1, 1, torch.float32, 1), (97, 192, torch.float32, 50),
                  (300, 64, torch.bfloat16, 300), (1001, 50, torch.float32, 333),
                  (1001, 25, torch.bfloat16, 77), (513, 7, torch.uint8, 200),
                  (5000, 3, torch.float64, 4999)]


@pytest.mark.parametrize("N,W,dtype,R", SCATTER_SHAPES)
def test_scatter_rows_kernel_equals_plain(dev, N, W, dtype, R):
    gen = torch.Generator().manual_seed(N * W + R)
    table = torch.randint(0, 200, (N, W), generator=gen).to(dtype)
    block = torch.randint(0, 200, (R, W), generator=gen).to(dtype)
    rows = torch.randperm(N, generator=gen)[:R].to(torch.int32)
    rows[::7] = N + 3                     # dropped
    if R > 1:
        rows[1] = -2                      # dropped
    before = CS.scatter_rows.launches
    t = table.to(dev)
    got = CS.scatter_rows(t, rows.to(dev), block.to(dev))
    assert got is t and CS.scatter_rows.launches == before + 1
    want = CS.scatter_rows_plain(table.clone(), rows, block)
    assert torch.equal(got.cpu(), want)


def test_scatter_rows_unaligned_views_and_empty(dev):
    """A block that starts 4 bytes into its storage leaves the 16-byte
    path; R = 0 launches nothing."""
    table = torch.zeros(64, 8, device=dev)
    store = torch.arange(1 + 16 * 8, dtype=torch.float32, device=dev)
    block = store[1:].view(16, 8)
    rows = torch.arange(16, dtype=torch.int32, device=dev) * 3
    CS.scatter_rows(table, rows, block)
    assert torch.equal(table[rows.long()], block)
    before = CS.scatter_rows.launches
    CS.scatter_rows(table, rows[:0], block[:0])
    assert CS.scatter_rows.launches == before
