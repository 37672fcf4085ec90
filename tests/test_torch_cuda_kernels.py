"""The port's CUDA kernels against their plain versions ON THE CARD, at
ragged shapes chip_smoke.py does not reach (B, N and D off the tile
sizes, D below and above one 64-dim stage, bias, col_offset, n_valid).
Integer-valued inputs make every f32 sum exact, so results must be equal.
The Adam commit takes Gaussian inputs and must equal its plain version
(the eager PyTorch ops on the same CUDA tensors) bit for bit; the dense
Adam kernel, over three steps, must come within 2 float32 ulp of its
plain version element by element. The grouped rescore must also give,
on Gaussian inputs, each selected bucket's B2 maximum bit for bit.

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
from rechorus_tpu_torch.ops import lazy_adam as LA
from rechorus_tpu_torch.ops import topk as TT
from rechorus_tpu_torch.runners import base as tbase
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


@pytest.mark.parametrize("n_valid", [8192, 4097, 1697, 1])
def test_ge_count_on_a_tiled_chunk_slice(dev, n_valid):
    """The candidate-tiled evaluation's B1 call: a [256, 8192] chunk's
    Gaussian prediction sliced to its valid columns (the whole chunk, a
    ragged cut, the last chunk of a 100,001-id catalog, a one-column
    chunk), against the plain
    count of the same slice; the chunks' counts add up to the whole row's."""
    gen = torch.Generator(device=dev).manual_seed(n_valid)
    pred = torch.randn(256, 2 * 8192, generator=gen, device=dev)
    target = pred[:, 17].contiguous()
    parts = [pred[:, :8192], pred[:, 8192:8192 + n_valid]]
    before = CK.ge_count.launches
    got = [CK.ge_count(p.contiguous(), target) for p in parts]
    assert CK.ge_count.launches == before + 2
    for g, p in zip(got, parts):
        assert torch.equal(g, CK.ge_count_plain(p, target))
    assert torch.equal(got[0] + got[1], CK.ge_count_plain(pred[:, :8192 + n_valid], target))


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


def test_serve_results_outlive_the_next_query(dev):
    """`ServeIndex.query` copies its results through pinned host blocks:
    a result keeps its values after the next query reuses those blocks,
    and both equal the CPU index's, in its dtypes."""
    rng = np.random.default_rng(14)
    u_table = rng.normal(size=(40, 8)).astype(np.float32)
    i_table = rng.integers(-8, 9, size=(16384 + 5, 8)).astype(np.float32)
    idx = ServeIndex.from_tables(u_table, i_table, k=10)
    cpu = ServeIndex.from_tables(u_table, i_table, k=10, device="cpu")
    first = idx.query(np.arange(1, 17))
    kept = [a.copy() for a in first]
    second = idx.query(np.arange(17, 33))
    for a, b in zip(first, kept):
        np.testing.assert_array_equal(a, b)
    for got, users in ((first, np.arange(1, 17)), (second, np.arange(17, 33))):
        want = cpu.query(users)
        assert [a.dtype for a in got] == [a.dtype for a in want]
        np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=1e-5)


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


# N, R, D of the Adam commit: R from 1 to 8193, D off the 4-float unit
COMMIT_SHAPES = [(10, 1, 4), (300, 257, 64), (5000, 4096, 64), (20000, 8193, 64),
                 (2000, 1000, 130), (500, 300, 7), (3000, 513, 100)]


def _commit_case(gen, N, R, D, dtype):
    p = (torch.randn(N, D, generator=gen) * 0.05).to(dtype)
    mu = torch.randn(N, D, generator=gen) * 0.01
    nu = torch.rand(N, D, generator=gen) * 1e-3
    rows, scatter, _ = LA.unique_rows_hashed(torch.randint(0, N, (R,), generator=gen), N)
    scatter[::11] = -1                    # winners dropped too
    g = torch.randn(R, D, generator=gen) * 0.1
    return p, mu, nu, rows, scatter, g


@pytest.mark.parametrize("l2", [0.0, 1e-4])
@pytest.mark.parametrize("layout", ["packed", "rows_f32", "rows_bf16"])
@pytest.mark.parametrize("N,R,D", COMMIT_SHAPES)
def test_adam_commit_kernel_equals_plain(dev, N, R, D, layout, l2):
    gen = torch.Generator().manual_seed(N + R + D)
    tx = LA.LazyAdamTx(1e-3, l2)
    bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, 3)
    dtype = torch.bfloat16 if layout == "rows_bf16" else torch.float32
    p, mu, nu, rows, scatter, g = (t.to(dev) for t in _commit_case(gen, N, R, D, dtype))
    before = LA.adam_commit.launches
    if layout == "packed":
        table = torch.cat([p, mu, nu], dim=1)
        want = LA.adam_commit_plain(tx, bc1, bc2, l2, table.clone(), g, scatter,
                                    gathered=table[rows])
        got = LA.adam_commit(tx, bc1, bc2, l2, table, g, scatter, gathered=table[rows].clone())
        assert got is table and torch.equal(got, want)
    else:
        vals = p[rows].float()
        want = [t.clone() for t in (p, mu, nu)]
        LA.adam_commit_plain(tx, bc1, bc2, l2, want[0], g, scatter, vals=vals, rows=rows,
                             mu=want[1], nu=want[2])
        LA.adam_commit(tx, bc1, bc2, l2, p, g, scatter, vals=vals, rows=rows, mu=mu, nu=nu)
        for name, a, b in zip(("p", "mu", "nu"), (p, mu, nu), want):
            assert torch.equal(a, b), name
    assert LA.adam_commit.launches == before + 1


@pytest.mark.parametrize("layout", ["packed", "rows_f32"])
def test_adam_commit_at_a_sequential_step(dev, layout):
    """A sequential model's item-table commit at batch 4096: the ids of the
    targets, one negative each and 20 history slots per row (a fifth of
    them the pad id 0), 4096 x 22 before dedup, over a 1M-item table:
    one [N, 192] packed block, or three [N, 64] tables."""
    N, B, H, D = 1_000_000, 4096, 20, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    history = torch.randint(1, N, (B, H), generator=gen, device=dev)
    history[torch.rand(B, H, generator=gen, device=dev) < 0.2] = 0
    ids = torch.cat([torch.randint(1, N, (2 * B,), generator=gen, device=dev), history.reshape(-1)])
    assert ids.shape[0] == B * 22
    rows, scatter, _ = LA.unique_rows_hashed(ids, N)
    R = ids.shape[0]
    p = torch.randn(N, D, generator=gen, device=dev) * 0.05
    mu = torch.randn(N, D, generator=gen, device=dev) * 0.01
    nu = torch.rand(N, D, generator=gen, device=dev) * 1e-3
    g = torch.randn(R, D, generator=gen, device=dev) * 0.1
    tx = LA.LazyAdamTx(1e-4, 1e-6)
    bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, 7)
    before = LA.adam_commit.launches
    if layout == "packed":
        table = torch.cat([p, mu, nu], dim=1)
        del p, mu, nu
        want = LA.adam_commit_plain(tx, bc1, bc2, tx.l2, table.clone(), g, scatter, gathered=table[rows])
        got = LA.adam_commit(tx, bc1, bc2, tx.l2, table, g, scatter, gathered=table[rows].clone())
        assert torch.equal(got, want)
    else:
        vals = p[rows]
        want = [t.clone() for t in (p, mu, nu)]
        LA.adam_commit_plain(tx, bc1, bc2, tx.l2, want[0], g, scatter, vals=vals, rows=rows,
                             mu=want[1], nu=want[2])
        LA.adam_commit(tx, bc1, bc2, tx.l2, p, g, scatter, vals=vals, rows=rows, mu=mu, nu=nu)
        for name, a, b in zip(("p", "mu", "nu"), (p, mu, nu), want):
            assert torch.equal(a, b), name
    assert LA.adam_commit.launches == before + 1
    assert int((scatter < N).sum()) == int(torch.unique(ids).numel())


@pytest.mark.parametrize("layout", ["packed", "rows_f32"])
def test_adam_commit_at_the_kda_entity_table(dev, layout):
    """KDA's entity-table commit on Grocery at batch 256: the rows of
    item_id [256, 2], history_items [256, 20] (a fifth pad), item_val
    [256, 2, 4] (attribute entities past the 8,714 items, else 0),
    head_id and tail_id [256, 2] and value_id [256], 256 x 35 = 8,960 ids
    before dedup, over the [8771, 64] table: one [8771, 192] packed block,
    or three [8771, 64] tables."""
    N, n_items, B, D = 8771, 8714, 256, 64
    gen = torch.Generator(device=dev).manual_seed(6)
    items = lambda *shape: torch.randint(1, n_items, shape, generator=gen, device=dev)  # noqa: E731
    history = items(B, 20)
    history[torch.rand(B, 20, generator=gen, device=dev) < 0.2] = 0
    item_val = torch.zeros(B, 2, 4, dtype=torch.long, device=dev)
    item_val[:, :, 3] = torch.randint(n_items, N, (B, 2), generator=gen, device=dev)
    value = torch.where(torch.rand(B, generator=gen, device=dev) < 0.3,
                        torch.randint(n_items, N, (B,), generator=gen, device=dev), 0)
    ids = torch.cat([items(B, 2).reshape(-1), history.reshape(-1), item_val.reshape(-1),
                     items(B, 2).reshape(-1), items(B, 2).reshape(-1), value])
    assert ids.shape[0] == B * 35
    rows, scatter, _ = LA.unique_rows_hashed(ids, N)
    R = ids.shape[0]
    p = torch.randn(N, D, generator=gen, device=dev) * 0.05
    mu = torch.randn(N, D, generator=gen, device=dev) * 0.01
    nu = torch.rand(N, D, generator=gen, device=dev) * 1e-3
    g = torch.randn(R, D, generator=gen, device=dev) * 0.1
    tx = LA.LazyAdamTx(1e-3, 1e-6)
    bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, 11)
    before = LA.adam_commit.launches
    if layout == "packed":
        table = torch.cat([p, mu, nu], dim=1)
        want = LA.adam_commit_plain(tx, bc1, bc2, tx.l2, table.clone(), g, scatter, gathered=table[rows])
        got = LA.adam_commit(tx, bc1, bc2, tx.l2, table, g, scatter, gathered=table[rows].clone())
        assert torch.equal(got, want)
    else:
        vals = p[rows]
        want = [t.clone() for t in (p, mu, nu)]
        LA.adam_commit_plain(tx, bc1, bc2, tx.l2, want[0], g, scatter, vals=vals, rows=rows,
                             mu=want[1], nu=want[2])
        LA.adam_commit(tx, bc1, bc2, tx.l2, p, g, scatter, vals=vals, rows=rows, mu=mu, nu=nu)
        for name, a, b in zip(("p", "mu", "nu"), (p, mu, nu), want):
            assert torch.equal(a, b), name
    assert LA.adam_commit.launches == before + 1
    assert int((scatter < N).sum()) == int(torch.unique(ids).numel())


def test_adam_commit_unaligned_views_and_empty(dev):
    """Bases 4 bytes (2 for a bf16 p) into their storage leave the 16-byte
    path; R = 0 launches nothing."""
    gen = torch.Generator().manual_seed(3)
    N, R, D = 64, 40, 8
    tx = LA.LazyAdamTx(1e-3, 1e-4)
    for dtype in (torch.float32, torch.bfloat16):
        p, mu, nu, rows, scatter, g = (t.to(dev) for t in _commit_case(gen, N, R, D, dtype))

        def shifted(t):
            store = torch.empty(1 + t.numel(), dtype=t.dtype, device=dev)
            store[1:] = t.ravel()
            return store[1:].view(t.shape)

        packed = torch.cat([p.float(), mu, nu], dim=1)
        want = LA.adam_commit_plain(tx, 0.1, 0.001, 1e-4, packed.clone(), g, scatter,
                                    gathered=packed[rows])
        got = LA.adam_commit(tx, 0.1, 0.001, 1e-4, shifted(packed), shifted(g), scatter,
                             gathered=shifted(packed[rows]))
        assert torch.equal(got, want)
        vals = p[rows].float()
        want = [t.clone() for t in (p, mu, nu)]
        LA.adam_commit_plain(tx, 0.1, 0.001, 1e-4, want[0], g, scatter, vals=vals, rows=rows,
                             mu=want[1], nu=want[2])
        got = [shifted(t) for t in (p, mu, nu)]
        LA.adam_commit(tx, 0.1, 0.001, 1e-4, got[0], shifted(g), scatter, vals=shifted(vals),
                       rows=rows, mu=got[1], nu=got[2])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    before = LA.adam_commit.launches
    LA.adam_commit(tx, 0.1, 0.001, 0.0, packed, g[:0], scatter[:0], gathered=packed[:0])
    assert LA.adam_commit.launches == before


def test_adam_commit_checks_its_inputs(dev):
    tx = LA.LazyAdamTx(1e-3, 0.0)
    table, g = torch.zeros(10, 12, device=dev), torch.zeros(3, 4, device=dev)
    ids = torch.tensor([1, 2, 3], device=dev)
    gathered = torch.zeros(3, 12, device=dev)
    commit = lambda *a, **k: LA.adam_commit(tx, 0.1, 0.001, 0.0, *a, **k)  # noqa: E731
    with pytest.raises(TypeError, match="dtype"):
        commit(table, g, ids.int(), gathered=gathered)
    with pytest.raises(ValueError, match="is on"):
        commit(table, g.cpu(), ids, gathered=gathered)
    with pytest.raises(ValueError, match="contiguous"):
        commit(table, torch.zeros(4, 3, device=dev).T, ids, gathered=gathered)
    with pytest.raises(TypeError, match="dtype"):
        commit(torch.zeros(10, 4, dtype=torch.float16, device=dev), g, ids,
               vals=torch.zeros(3, 4, device=dev), rows=ids, mu=torch.zeros(10, 4, device=dev),
               nu=torch.zeros(10, 4, device=dev))


def test_adam_commit_at_the_kda_item_bias_table(dev):
    """KDA's item_bias commit on Grocery at batch 256: the [8714, 1] bias
    packed as [8714, 3] (D = 1, the commit's scalar path), the rows of
    item_id [256, 2], no L2 (a bias is exempt), against the plain commit
    bit for bit."""
    N, B = 8714, 256
    gen = torch.Generator(device=dev).manual_seed(8)
    ids = torch.randint(1, N, (B * 2,), generator=gen, device=dev)
    rows, scatter, _ = LA.unique_rows_hashed(ids, N)
    table = torch.cat([torch.randn(N, 1, generator=gen, device=dev) * 0.05,
                       torch.randn(N, 1, generator=gen, device=dev) * 0.01,
                       torch.rand(N, 1, generator=gen, device=dev) * 1e-3], dim=1)
    g = torch.randn(B * 2, 1, generator=gen, device=dev) * 0.1
    tx = LA.LazyAdamTx(1e-3, 0.0)
    bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, 5)
    before = LA.adam_commit.launches
    want = LA.adam_commit_plain(tx, bc1, bc2, 0.0, table.clone(), g, scatter, gathered=table[rows])
    got = LA.adam_commit(tx, bc1, bc2, 0.0, table, g, scatter, gathered=table[rows].clone())
    assert LA.adam_commit.launches == before + 1
    assert torch.equal(got, want)
    assert int((scatter < N).sum()) > B                        # most of the 512 rows distinct


@pytest.mark.parametrize("N,D,per_row,l2", [
    (14682, 1, 1, 0.0),     # SLRCPlus's user_bias: the user ids of a batch, no L2 (a bias)
    (8714, 3, 2, 1e-5),     # SLRCPlus's five Hawkes tables (D = R = 3): target + negative ids
    (8771, 64, 35 + 40, 1e-6),   # ContraKDA's entity table: KDA's 35 ids a row + two 20-id views
], ids=["slrc_user_bias", "slrc_hawkes", "contrakda_entity"])
@pytest.mark.parametrize("layout", ["packed", "rows_f32"])
def test_adam_commit_at_the_sequential_family_tables(dev, N, D, per_row, l2, layout):
    """The lazy commits of the tables the rest of the sequential family
    adds on Grocery at batch 256 (a fifth of the ids the pad id 0), against
    the plain commit bit for bit, packed and three-table."""
    B = 256
    gen = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(1, N, (B * per_row,), generator=gen, device=dev)
    ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.2] = 0
    rows, scatter, _ = LA.unique_rows_hashed(ids, N)
    R = ids.shape[0]
    p = torch.randn(N, D, generator=gen, device=dev) * 0.05
    mu = torch.randn(N, D, generator=gen, device=dev) * 0.01
    nu = torch.rand(N, D, generator=gen, device=dev) * 1e-3
    g = torch.randn(R, D, generator=gen, device=dev) * 0.1
    tx = LA.LazyAdamTx(5e-4, l2)
    bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, 3)
    before = LA.adam_commit.launches
    if layout == "packed":
        table = torch.cat([p, mu, nu], dim=1)
        want = LA.adam_commit_plain(tx, bc1, bc2, l2, table.clone(), g, scatter, gathered=table[rows])
        got = LA.adam_commit(tx, bc1, bc2, l2, table, g, scatter, gathered=table[rows].clone())
        assert torch.equal(got, want)
    else:
        vals = p[rows]
        want = [t.clone() for t in (p, mu, nu)]
        LA.adam_commit_plain(tx, bc1, bc2, l2, want[0], g, scatter, vals=vals, rows=rows,
                             mu=want[1], nu=want[2])
        LA.adam_commit(tx, bc1, bc2, l2, p, g, scatter, vals=vals, rows=rows, mu=mu, nu=nu)
        for name, a, b in zip(("p", "mu", "nu"), (p, mu, nu), want):
            assert torch.equal(a, b), name
    assert LA.adam_commit.launches == before + 1
    assert int((scatter < N).sum()) == int(torch.unique(ids).numel())


# the dense Adam kernel's shapes: the 1M serving table's rows and the user
# table's, a LayerNorm vector, a [3]-wide bias table, an odd length
DENSE_SHAPES = [(1_000_001, 64), (200_000, 64), (64,), (3,), (1001, 7)]


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element, how many float32 values lie between a and b."""
    def ordered(x):
        i = x.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("scaled", [False, True], ids=["lr", "lr_scale"])
@pytest.mark.parametrize("l2", [0.0, 1e-4], ids=["no_l2", "l2"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adam_dense_kernel_equals_plain(dev, shape, name, l2, scaled):
    """Three steps of the kernel against the eager sequence on the same
    CUDA tensors: p, m and v within 2 float32 ulp of it, element by element
    (the message counts the elements that differ at all), one launch a
    step."""
    gen = torch.Generator(device=dev).manual_seed(len(shape) * 1000 + shape[0])
    tx = tbase.DenseOptimizer(name, 1e-3, l2)
    p = torch.randn(shape, generator=gen, device=dev) * 0.05
    m = torch.randn(shape, generator=gen, device=dev) * 0.01
    v = torch.rand(shape, generator=gen, device=dev) * 1e-3
    want = [t.clone() for t in (p, m, v)]
    kw = dict(decoupled=name == "adamw", scale=0.1 if scaled else None)
    before = LA.adam_dense.launches
    for count in range(1, 4):
        g = torch.randn(shape, generator=gen, device=dev) * 0.1
        bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, count)
        assert LA.adam_dense(tx, bc1, bc2, l2, p, g, m, v, **kw) is p
        LA.adam_dense_plain(tx, bc1, bc2, l2, want[0], g, want[1], want[2], **kw)
        assert LA.adam_dense.launches == before + count
        for key, a, b in zip(("p", "m", "v"), (p, m, v), want):
            ulps = _ulps(a, b)
            assert int(ulps.max()) <= 2, (key, count, int(ulps.max()), int((ulps > 0).sum()))


def test_adam_dense_unaligned_views_and_empty(dev):
    """Bases 4 bytes into their storage, or a length that is no multiple of
    4, take the one-float walk; an empty tensor launches nothing."""
    gen = torch.Generator(device=dev).manual_seed(4)
    tx = tbase.DenseOptimizer("adam", 1e-3, 1e-4)

    def shifted(t):
        store = torch.empty(1 + t.numel(), device=dev)
        store[1:] = t.ravel()
        return store[1:].view(t.shape)

    for n in (4096, 4099):
        p, g, m = (torch.randn(n, generator=gen, device=dev) * 0.05 for _ in range(3))
        v = torch.rand(n, generator=gen, device=dev) * 1e-3
        want = [t.clone() for t in (p, m, v)]
        LA.adam_dense_plain(tx, 0.1, 0.001, 1e-4, want[0], g, want[1], want[2])
        got = [shifted(t) for t in (p, m, v)]
        LA.adam_dense(tx, 0.1, 0.001, 1e-4, got[0], shifted(g), got[1], got[2])
        for a, b in zip(got, want):
            assert int(_ulps(a, b).max()) <= 2
    before = LA.adam_dense.launches
    e = torch.zeros(0, 64, device=dev)
    LA.adam_dense(tx, 0.1, 0.001, 0.0, e, e.clone(), e.clone(), e.clone())
    assert LA.adam_dense.launches == before


def test_adam_dense_checks_its_inputs(dev):
    tx = tbase.DenseOptimizer("adam", 1e-3, 0.0)
    p, g, m, v = (torch.zeros(4, 6, device=dev) for _ in range(4))
    step = lambda *a: LA.adam_dense(tx, 0.1, 0.001, 0.0, *a)  # noqa: E731
    before = LA.adam_dense.launches
    with pytest.raises(ValueError, match="contiguous"):
        step(p, torch.zeros(6, 4, device=dev).T, m, v)
    with pytest.raises(TypeError, match="dtype"):
        step(p.double(), g.double(), m.double(), v.double())
    with pytest.raises(ValueError, match="is on"):
        step(p, g.cpu(), m, v)
    assert LA.adam_dense.launches == before


def test_dense_optimizer_launches_one_kernel_a_tensor(dev):
    """DenseOptimizer.update on the card: one launch per parameter per step,
    and the parameters as the plain sequence leaves them within 2 ulp."""
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = {"u_embeddings.weight": (2001, 64), "i_embeddings.weight": (5001, 64),
              "ln.weight": (64,), "item_bias.weight": (5001, 1)}
    params = {k: torch.randn(s, generator=gen, device=dev) * 0.1 for k, s in shapes.items()}
    want = {k: p.clone() for k, p in params.items()}
    opt = tbase.build_optimizer("Adam", 1e-3, 1e-6)
    state, slots = opt.init(params), opt.init(want)
    before = LA.adam_dense.launches
    for count in range(1, 4):
        grads = {k: torch.randn(s, generator=gen, device=dev) * 0.05 for k, s in shapes.items()}
        opt.update(params, grads, state)
        bc1, bc2 = LA.bias_corrections(opt.b1, opt.b2, count)
        for k in shapes:
            decay = 0.0 if "bias" in k else opt.l2
            LA.adam_dense_plain(opt, bc1, bc2, decay, want[k], grads[k], slots.slots["mu"][k],
                                slots.slots["nu"][k])
    assert LA.adam_dense.launches == before + 3 * len(shapes)
    for k in shapes:
        assert int(_ulps(params[k], want[k]).max()) <= 2, k


@pytest.mark.parametrize("B,N,L", [(1, 1, 1), (3, 4097, 513), (5, 62592, 7824), (2, 100001, 12501),
                                   (70000, 3, 2)])
def test_approx_bin_max_kernel_equals_plain(dev, B, N, L):
    """The bin max on integer-valued inputs (many ties, so the lowest-column
    rule is exercised), with -inf columns and a row of -inf, at ragged
    shapes, the approx lane's shapes, and more rows than the grid's y axis
    holds: maxima and columns equal the plain version's."""
    gen = torch.Generator().manual_seed(B + N)
    x = _ints(gen, B, N, lo=-3, hi=4)
    x[torch.rand(B, N, generator=gen) < 0.3] = float("-inf")
    x[0] = float("-inf")
    before = CT.approx_bin_max.launches
    vals, cols = CT.approx_bin_max(x.to(dev), L)
    assert CT.approx_bin_max.launches == before + 1
    want_v, want_c = CT.approx_bin_max_plain(x, L)
    torch.testing.assert_close(vals.cpu(), want_v, rtol=0, atol=0)
    torch.testing.assert_close(cols.cpu(), want_c, rtol=0, atol=0)


def test_approx_bin_max_checks_its_inputs(dev):
    x = torch.zeros(2, 10, device=dev)
    with pytest.raises(ValueError, match="L=11"):
        CT.approx_bin_max(x, 11)
    with pytest.raises(TypeError, match="dtype"):
        CT.approx_bin_max(x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        CT.approx_bin_max(torch.zeros(10, 2, device=dev).T, 4)


# B, N, D, bias, col_offset, n_valid offset: B off 128 / K for every K,
# D = 64 (the template instance) and run-time widths below and above a stage
INTEREST_SHAPES = [
    (1, 1, 64, False, 0, None),
    (37, 4197, 64, True, 7, -40),
    (130, 2049, 64, False, 0, 5),
    (300, 20481, 64, True, 0, -1),
    (5, 511, 24, True, 2, -2),
    (129, 2048, 100, False, 11, None),
]


@pytest.mark.parametrize("K", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("B,N,D,with_bias,off,nv", INTEREST_SHAPES)
def test_interest_ge_kernel_equals_plain(dev, K, B, N, D, with_bias, off, nv):
    """The rank count over u [B, K, D] (`rtt_interest_ge_kernel`; at K = 1
    `rtt_fused_ge_kernel`) on integer-valued inputs, so every score and
    every max is exact: counts equal the plain version's with and without
    the target's id, under the n_valid, col_offset and bias masks, in one
    launch; at K = 1 they equal the count over u [B, D] too. K = 3 is
    widened to 4 by repeating interest 0, and K = 8 takes the permuted
    layout."""
    gen = torch.Generator().manual_seed(B + N + D + K)
    u, t = _ints(gen, B, K, D, lo=-3, hi=4), _ints(gen, N, D, lo=-3, hi=4)
    bias = _ints(gen, N) if with_bias else None
    n_valid = None if nv is None else N + off + nv
    kw = dict(bias=bias, n_valid=n_valid, col_offset=off)
    kw_dev = dict(kw, bias=None if bias is None else bias.to(dev))
    tgt = torch.randint(0, N, (B,), generator=gen)
    tscore = CT.interest_scores(u, t, bias)[torch.arange(B), tgt].contiguous()
    tscore[::3] += 0.5                         # off the integer grid: no tie at the target
    tcol = (tgt + off).to(torch.int32)
    for target_col in (tcol, None):
        kw_t = dict(kw_dev, target_col=None if target_col is None else target_col.to(dev))
        before = CT.fused_ge_count.launches
        got = CT.fused_ge_count(u.to(dev), t.to(dev), tscore.to(dev), **kw_t)
        assert CT.fused_ge_count.launches == before + 1
        want = CT.fused_ge_count_plain(u, t, tscore, target_col=target_col, **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        if K == 1:
            one = CT.fused_ge_count(u[:, 0].contiguous().to(dev), t.to(dev), tscore.to(dev),
                                    **kw_t)
            assert torch.equal(got, one)


def test_interest_routes_on_card_match_cpu(dev):
    """The multi-interest ranks and top-k at a catalog above
    MIN_ROWS_FOR_TILED on the card equal the CPU's plain route on
    integer-valued inputs; targets sit among the clicked ids."""
    rng = np.random.default_rng(14)
    B, K, N, D, k = 45, 4, 16384 + 37, 24, 50
    u = torch.from_numpy(rng.integers(-8, 9, size=(B, K, D)).astype(np.float32))
    t = torch.from_numpy(rng.integers(-8, 9, size=(N, D)).astype(np.float32))
    clicked = torch.from_numpy(rng.integers(0, N, size=(B, 9)).astype(np.int32))
    tgt = torch.from_numpy(rng.integers(1, N, size=(B,)).astype(np.int32))
    clicked[:, 0] = tgt
    grouped = TT.group_table_for_rescore(t)
    v_c, _ = TT.tiled_catalog_topk(u, t, k, clicked_rows=clicked, n_valid=N - 3,
                                   grouped_table=grouped)
    v_g, _ = TT.tiled_catalog_topk(u.to(dev), t.to(dev), k, clicked_rows=clicked.to(dev),
                                   n_valid=N - 3, grouped_table=grouped.to(dev))
    torch.testing.assert_close(v_g.cpu(), v_c, rtol=0, atol=0)   # integer scores: exact
    r_c = TT.tiled_catalog_ranks(u, t, tgt, clicked, n_valid=N - 3)
    before = CT.fused_ge_count.launches
    r_g = TT.tiled_catalog_ranks(u.to(dev), t.to(dev), tgt.to(dev), clicked.to(dev),
                                 n_valid=N - 3)
    assert CT.fused_ge_count.launches == before + 1
    torch.testing.assert_close(r_g.cpu(), r_c, rtol=0, atol=0)


def test_interest_kernel_checks_its_inputs(dev):
    t = torch.zeros(300, 8, device=dev)
    with pytest.raises(ValueError, match="at most 8"):
        CT.fused_ge_count(torch.zeros(4, 9, 8, device=dev), t, torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match=r"expected \[B, D\] or \[B, K, D\]"):
        CT.fused_ge_count(torch.zeros(4, 2, 2, 8, device=dev), t, torch.zeros(4, device=dev))
    with pytest.raises(TypeError, match="dtype"):
        CT.fused_ge_count(torch.zeros(4, 2, 8, device=dev).double(), t.double(),
                          torch.zeros(4, device=dev))


# B, N, bucket, col_offset, n_valid offset: overhang in the last catalog
# block, bucket 16 (the main path's) and off it, a shard's offset, n_valid
# below and above the table's end
RESCORE_SHAPES = [
    (1, 1, 16, 0, None),
    (37, 4197, 16, 7, -40),
    (130, 2049, 2, 0, 5),
    (300, 20481, 16, 0, -1),
    (5, 511, 4, 2, -2),
]


def _rescore_case(gen, B, N, D, K, bucket, kk, with_bias, lo=-8, hi=9):
    """Integer u [B, D] (or [B, K, D]), table, bias; the grouped copy; kk
    selected buckets a user (the last bucket among them: its overhang) and
    their maxima, the last four slots of user 0 pads."""
    u = _ints(gen, *((B, K, D) if K > 1 else (B, D)), lo=lo, hi=hi)
    t = _ints(gen, N, D, lo=lo, hi=hi)
    bias = _ints(gen, N) if with_bias else None
    grouped = TT.group_table_for_rescore(t, bucket=bucket)
    G = grouped.shape[0]
    kk = min(kk, G)
    gb = torch.randint(0, G, (B, kk), generator=gen)
    gb[:, 0] = G - 1
    gv = torch.randn(B, kk, generator=gen)
    gv[0, -4:] = float("-inf")
    return u, t, bias, grouped, gb, gv


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("D", [24, 33, 64, 100, 128])
@pytest.mark.parametrize("B,N,bucket,off,nv", RESCORE_SHAPES)
def test_bucket_rescore_kernel_equals_plain(dev, B, N, bucket, off, nv, D, K, with_bias):
    """The grouped rescore (`rtt_bucket_rescore_kernel`) on integer-valued
    inputs, so every sum is exact: scores and ids equal the plain version's
    under the overhang, pad, n_valid, col_offset and bias masks, in one
    launch. D = 33 takes the 4-byte copies, the others the 16-byte ones."""
    gen = torch.Generator().manual_seed(B + N + D + K + bucket)
    u, t, bias, grouped, gb, gv = _rescore_case(gen, B, N, D, K, bucket, 40, with_bias)
    kw = dict(n_rows=N, bias=bias, n_valid=None if nv is None else N + off + nv, col_offset=off)
    want_s, want_c = CT.bucket_rescore_plain(u, grouped, gb, gv, **kw)
    before = CT.bucket_rescore.launches
    cs, cand = CT.bucket_rescore(u.to(dev), grouped.to(dev), gb.to(dev), gv.to(dev),
                                 **dict(kw, bias=None if bias is None else bias.to(dev)))
    assert CT.bucket_rescore.launches == before + 1
    torch.testing.assert_close(cs.cpu(), want_s, rtol=0, atol=0)
    assert torch.equal(cand.cpu(), want_c)


def test_bucket_rescore_unaligned_user_rows(dev):
    """u a contiguous view 4 bytes off a 16-byte boundary: the 4-byte path,
    equal to the plain version."""
    gen = torch.Generator().manual_seed(5)
    B, N, D, K = 21, 4197, 64, 1
    u, t, bias, grouped, gb, gv = _rescore_case(gen, B, N, D, K, 16, 30, True)
    buf = torch.empty(B * D + 1, device=dev)
    u_dev = buf[1:].view(B, D)
    u_dev.copy_(u)
    kw = dict(n_rows=N, bias=bias, n_valid=N - 3)
    want_s, want_c = CT.bucket_rescore_plain(u, grouped, gb, gv, **kw)
    cs, cand = CT.bucket_rescore(u_dev, grouped.to(dev), gb.to(dev), gv.to(dev),
                                 **dict(kw, bias=bias.to(dev)))
    torch.testing.assert_close(cs.cpu(), want_s, rtol=0, atol=0)
    assert torch.equal(cand.cpu(), want_c)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("D,with_bias", [(64, True), (64, False), (100, True), (24, False)])
def test_bucket_rescore_max_is_the_bucket_max(dev, D, K, with_bias):
    """On Gaussian inputs the largest rescored score of every selected
    bucket equals `fused_bucket_max`'s value for it bit for bit: the kernel
    sums as B2 does (for K interests, B2 over the B * K rows and the max
    over k), under the n_valid and col_offset masks."""
    gen = torch.Generator(device=dev).manual_seed(D + K)
    B, N, kk, off = 300, 100_003, 132, 5
    u = torch.randn(B, K, D, generator=gen, device=dev) if K > 1 else \
        torch.randn(B, D, generator=gen, device=dev)
    t = torch.randn(N, D, generator=gen, device=dev)
    bias = torch.randn(N, generator=gen, device=dev) if with_bias else None
    kw = dict(bias=bias, n_valid=N + off - 9, col_offset=off)
    bm = CT.fused_bucket_max(u.reshape(B * K, D), t, bucket=TT.DEFAULT_BUCKET, **kw)
    bm = bm.view(B, K, -1).amax(1)
    gv, gb = torch.topk(bm, kk, dim=1)
    cs, _ = CT.bucket_rescore(u, TT.group_table_for_rescore(t), gb, gv, n_rows=N, **kw)
    assert torch.isfinite(gv).all()
    assert torch.equal(cs.view(B, kk, -1).amax(-1), gv)


@pytest.mark.parametrize("K", [1, 4])
def test_tiled_topk_on_card_matches_a_float64_top_k(dev, K):
    """`tiled_catalog_topk` with the grouped copy on the card, Gaussian
    inputs, against a dense float64 top-k with the same masks: scores
    within rtol 2e-5, and ids equal but where the scores tie within that
    (the serve tests' rule); every score the float64 score of its id.
    One rescore launch a call on the card; the same call on CPU tensors
    (the plain route) launches none and meets the same rule."""
    gen = torch.Generator(device=dev).manual_seed(40 + K)
    B, N, D, k, M = 64, 50_000, 64, 100, 32
    u = torch.randn(B, K, D, generator=gen, device=dev) if K > 1 else \
        torch.randn(B, D, generator=gen, device=dev)
    t = torch.randn(N, D, generator=gen, device=dev)
    bias = torch.randn(N, generator=gen, device=dev)
    n_valid = N - 7
    s64 = (u.double().reshape(B, K, D) @ t.double().T).amax(1) + bias.double()
    clicked = torch.randint(1, n_valid, (B, M), generator=gen, device=dev).to(torch.int32)
    clicked[:, :4] = s64[:, 1:n_valid].topk(4, dim=1).indices.to(torch.int32) + 1  # the best are clicked
    masked = s64.clone()
    masked[:, 0] = masked[:, n_valid:] = float("-inf")
    masked.scatter_(1, clicked.long(), float("-inf"))
    v64, i64 = masked.topk(k, dim=1)
    kw = dict(bias=bias, clicked_rows=clicked, n_valid=n_valid)
    before = CT.bucket_rescore.launches
    v, i = TT.tiled_catalog_topk(u, t, k, grouped_table=TT.group_table_for_rescore(t), **kw)
    assert CT.bucket_rescore.launches == before + 1
    v_plain, i_plain = TT.tiled_catalog_topk(u.cpu(), t.cpu(), k,
                                             grouped_table=TT.group_table_for_rescore(t.cpu()),
                                             bias=bias.cpu(), clicked_rows=clicked.cpu(),
                                             n_valid=n_valid)
    v_plain, i_plain = v_plain.to(dev), i_plain.to(dev)
    assert CT.bucket_rescore.launches == before + 1
    for vv, ii in ((v, i), (v_plain, i_plain)):
        vv, ii = vv.double(), ii.long()
        torch.testing.assert_close(vv, v64, rtol=2e-5, atol=1e-5)
        diff = ii != i64
        torch.testing.assert_close(vv[diff], v64[diff], rtol=2e-5, atol=0)
        torch.testing.assert_close(vv, s64.gather(1, ii), rtol=2e-5, atol=1e-5)
        assert not (ii[:, :, None] == clicked.long()[:, None, :]).any()


def test_bucket_rescore_checks_its_inputs(dev):
    u, g = torch.zeros(4, 8, device=dev), torch.zeros(10, 16, 8, device=dev)
    gb = torch.zeros(4, 3, dtype=torch.int64, device=dev)
    gv = torch.zeros(4, 3, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        CT.bucket_rescore(u, g, gb.int(), gv, n_rows=160)
    with pytest.raises(ValueError, match="shape"):
        CT.bucket_rescore(u, g, gb, gv[:3], n_rows=160)
    with pytest.raises(ValueError, match="n_rows"):
        CT.bucket_rescore(u, g, gb, gv, n_rows=161)
    with pytest.raises(ValueError, match="at most 8"):
        CT.bucket_rescore(torch.zeros(4, 9, 8, device=dev), g, gb, gv, n_rows=160)
    with pytest.raises(ValueError, match="is on"):
        CT.bucket_rescore(u, g.cpu(), gb, gv, n_rows=160)


def _select_limit(G, fan):
    """The largest kk that `bucket_select` takes at G and fan."""
    return max(kk for kk in range(1, 4 * TT.TWO_LEVEL_FAN_WIDE * 128)
               if CT.bucket_select_fits(G, kk, fan))


# B, G, kk, fan: the main paths' shapes (serving at 1M items, k 100 + 32
# clicked; the 100k exact lane; a [250001, 64] shard of the 1M table; a
# 10M catalog's 39,064 super maxima; the runner's top-100 with 1,000
# clicked ids), a partial last super, kk 1, kk of one super, and kk at the
# kernel's limit
SELECT_SHAPES = [
    (4096, 62592, 132, 16),
    (64, 6272, 132, 8),
    (64, 15744, 132, 8),
    (4, 625024, 132, 16),
    (16, 62592, 1100, 16),
    (9, 7004, 40, 16),
    (8, 62592, 1, 16),
    (8, 62592, 12, 16),
    (8, 62592, "limit", 16),
]


def _select_rows(gen, B, G, kk, fan):
    """Gaussian [B, G] bucket maxima with planted rows: -inf pad columns
    (B2's overhang), fewer than kk finite columns, exact ties across the kk
    boundary, and every winner in as few supers as hold kk columns."""
    bm = torch.randn(B, G, generator=gen)
    bm[0, G - 300:] = float("-inf")
    bm[1] = float("-inf")
    bm[1, torch.randperm(G, generator=gen)[:kk // 2]] = 1.0 + torch.rand(kk // 2, generator=gen)
    top = bm[2].topk(kk + 5).indices
    bm[2, top[max(kk - 3, 0):]] = float(bm[2, top[kk - 1]])
    s = int(torch.randint(0, G // fan - kk // fan - 1, (1,), generator=gen))
    bm[3] -= 10.0
    bm[3, s * fan: s * fan + kk] = 10.0 + torch.rand(kk, generator=gen)
    return bm


@pytest.mark.parametrize("B,G,kk,fan", SELECT_SHAPES)
def test_bucket_select_kernel_equals_plain(dev, B, G, kk, fan):
    """D11 (`rtt_bucket_select_kernel`) against its plain version (the
    two top-k passes it replaced): every value is bm at its id bit for
    bit, ids in [0, G); the kk values equal the plain version's as sorted
    lists, and the ids equal it as sets wherever the kk-th value has no
    tie outside the kk (else the ids above the kk-th value equal as sets);
    one launch a call, and a second call returns the same tensors."""
    if kk == "limit":
        kk = _select_limit(G, fan)
        assert not CT.bucket_select_fits(G, kk + 1, fan)
    gen = torch.Generator().manual_seed(G + kk + fan)
    bm = _select_rows(gen, B, G, kk, fan)
    bm_dev = bm.to(dev)
    before = CT.bucket_select.launches
    gv, gb = CT.bucket_select(bm_dev, kk, fan)
    assert CT.bucket_select.launches == before + 1
    again = CT.bucket_select(bm_dev, kk, fan)
    assert torch.equal(again[0], gv) and torch.equal(again[1], gb)
    gv, gb = gv.cpu(), gb.cpu()
    assert gb.dtype == torch.int64 and gb.shape == (B, kk) and gv.shape == (B, kk)
    assert ((gb >= 0) & (gb < G)).all()
    assert torch.equal(bm.gather(1, gb).view(torch.int32), gv.view(torch.int32))
    v_ref, i_ref = CT.bucket_select_plain(bm, kk, fan)
    assert torch.equal(gv.sort(1, descending=True).values, v_ref)
    kth = v_ref[:, -1:]

    def above(v, i):
        return i.masked_fill(~(v > kth), -1).sort(1).values

    assert torch.equal(above(gv, gb), above(v_ref, i_ref))
    distinct = (bm >= kth).sum(1) == kk
    assert distinct[0] and distinct[3] and not distinct[1] and not distinct[2]
    assert torch.equal(gb[distinct].sort(1).values, i_ref[distinct].sort(1).values)
    assert torch.isneginf(gv[1]).sum() == kk - kk // 2


def test_bucket_select_checks_its_inputs(dev):
    bm = torch.zeros(4, 7000, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        CT.bucket_select(bm.double(), 40, 8)
    with pytest.raises(ValueError, match="contiguous"):
        CT.bucket_select(torch.zeros(7000, 4, device=dev).T, 40, 8)
    with pytest.raises(ValueError, match="limits"):       # keys past shared memory
        CT.bucket_select(torch.zeros(2, 62592, device=dev), 3374, 16)
    with pytest.raises(ValueError, match="limits"):       # more than the 875 supers
        CT.bucket_select(bm, 876, 8)
    with pytest.raises(ValueError, match="limits"):       # a ragged G: no 16-byte loads
        CT.bucket_select(torch.zeros(4, 7001, device=dev), 40, 8)
    with pytest.raises(ValueError, match="limits"):       # 3 threads a super
        CT.bucket_select(bm, 40, 12)
    with pytest.raises(ValueError, match="aligned"):
        CT.bucket_select(torch.zeros(4 * 7000 + 1, device=dev)[1:].view(4, 7000), 40, 8)
    assert CT.bucket_select(bm[:0], 40, 8)[1].shape == (0, 40)


def test_tiled_topk_on_card_selects_buckets_in_one_launch(dev):
    """`tiled_catalog_topk` at the 100k exact lane's G (6,272 >= the
    two-level select's 6,144, fan 8): one D11 and one D6 launch a call,
    and the top-100 of Gaussian scores equals the same call on CPU tensors
    (the plain select and rescore) up to ties, and a float64 top-k."""
    gen = torch.Generator(device=dev).manual_seed(22)
    B, N, D, k, M = 64, 100_001, 64, 100, 32
    u = torch.randn(B, D, generator=gen, device=dev)
    t = torch.randn(N, D, generator=gen, device=dev)
    clicked = torch.randint(1, N, (B, M), generator=gen, device=dev).to(torch.int32)
    s64 = u.double() @ t.double().T
    masked = s64.clone()
    masked[:, 0] = float("-inf")
    masked.scatter_(1, clicked.long(), float("-inf"))
    v64, i64 = masked.topk(k, dim=1)
    sel, res = CT.bucket_select.launches, CT.bucket_rescore.launches
    v, i = TT.tiled_catalog_topk(u, t, k, grouped_table=TT.group_table_for_rescore(t),
                                 clicked_rows=clicked)
    assert (CT.bucket_select.launches, CT.bucket_rescore.launches) == (sel + 1, res + 1)
    v_cpu, i_cpu = TT.tiled_catalog_topk(u.cpu(), t.cpu(), k, clicked_rows=clicked.cpu(),
                                         grouped_table=TT.group_table_for_rescore(t.cpu()))
    assert CT.bucket_select.launches == sel + 1
    torch.testing.assert_close(v.cpu(), v_cpu, rtol=2e-5, atol=1e-5)
    for vv, ii in ((v, i), (v_cpu.to(dev), i_cpu.to(dev))):
        vv, ii = vv.double(), ii.long()
        torch.testing.assert_close(vv, v64, rtol=2e-5, atol=1e-5)
        diff = ii != i64
        torch.testing.assert_close(vv[diff], v64[diff], rtol=2e-5, atol=0)
