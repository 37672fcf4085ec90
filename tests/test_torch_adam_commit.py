"""The lazy-Adam row commit `lazy_adam.adam_commit` (the sparse lanes'
commit kernel; on CPU tensors its plain version runs) against the JAX
package's `lazy_adam_sparse_step` and `lazy_adam_sparse_step_packed` for
one step on the same numpy-seeded inputs, and its two layouts against
each other.

Tolerances: 1e-6 absolute in f32 on parameters of O(0.1) and moments of
O(1e-2) (the two sides round the bias-corrected moments in other ways:
a division here, whatever XLA's CPU backend emits there); a bf16
parameter within one bf16 ulp of the larger of its start and end
magnitude (an f32 value one ulp apart may round to the other bf16
neighbour).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu.ops import lazy_adam as JLA
from rechorus_tpu_torch.ops import lazy_adam as LA

N, D, N_IDS, LR, COUNT = 60, 8, 48, 1e-2, 3
PATH = ("emb",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, dtype: str):
    """p [N, D] (rounded to `dtype`), mu, nu [N, D] f32, the step's ids
    with duplicates, and their dedup: rows, scatter (losers at N) with two
    more slots sent out of range above, g [R, D]."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((rng.normal(size=(N, D)) * 0.1).astype(np.float32))
    p = p.to(getattr(torch, dtype))
    mu = (rng.normal(size=(N, D)) * 0.01).astype(np.float32)
    nu = rng.uniform(0, 1e-3, size=(N, D)).astype(np.float32)
    ids = rng.integers(0, N, size=N_IDS)
    rows, scatter, _ = LA.unique_rows_hashed(torch.from_numpy(ids), N)
    winners = (scatter < N).nonzero().ravel()
    scatter[winners[:2]] = torch.tensor([N, N + 7])   # dropped by both sides
    assert bool((scatter >= N).any()) and int((scatter < N).sum()) > N_IDS // 4
    g = (rng.normal(size=(N_IDS, D)) * 0.1).astype(np.float32)
    return p, mu, nu, rows, scatter, g


def _jax_step(layout, p, mu, nu, rows, scatter, g, l2):
    tx = JLA.LazyAdamTx(lr=LR, l2=l2)
    jp = jnp.asarray(p.float().numpy()).astype(jnp.bfloat16 if p.dtype == torch.bfloat16
                                               else jnp.float32)
    state = JLA.LazyAdamState(count=jnp.asarray(COUNT - 1, jnp.int32), mu={"emb": jnp.asarray(mu)},
                              nu={"emb": jnp.asarray(nu)})
    info = {PATH: (jnp.asarray(rows.numpy(), jnp.int32), jnp.asarray(scatter.numpy(), jnp.int32))}
    jrows = info[PATH][0]
    if layout == "rows":
        params, state = JLA.lazy_adam_sparse_step(tx, {"emb": jp}, state, info,
                                                  {PATH: jp[jrows].astype(jnp.float32)},
                                                  {PATH: jnp.asarray(g)}, {})
    else:
        params, state, dtypes = JLA.pack_lazy_leaves({"emb": jp}, state, [PATH])
        params, state = JLA.lazy_adam_sparse_step_packed(
            tx, params, state, info, {PATH: params["emb"][jrows]}, {PATH: jnp.asarray(g)}, {})
        params, state = JLA.unpack_lazy_leaves(params, state, dtypes)
    return [np.asarray(x.astype(jnp.float32)) for x in (params["emb"], state.mu["emb"],
                                                        state.nu["emb"])]


def _port_step(layout, p, mu, nu, rows, scatter, g, l2):
    """(p, mu, nu) after one adam_commit in `layout`, as new tensors."""
    tx = LA.LazyAdamTx(LR, l2)
    bc1, bc2 = LA.bias_corrections(tx.b1, tx.b2, COUNT)
    g = torch.from_numpy(g)
    if layout == "rows":
        p, mu, nu = p.clone(), torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy())
        out = LA.adam_commit(tx, bc1, bc2, l2, p, g, scatter, vals=p[rows].float(), rows=rows,
                             mu=mu, nu=nu)
        assert out is p
        return p, mu, nu
    packed = torch.cat([p.float(), torch.from_numpy(mu), torch.from_numpy(nu)], dim=1)
    out = LA.adam_commit(tx, bc1, bc2, l2, packed, g, scatter, gathered=packed[rows])
    assert out is packed
    return packed[:, :D].to(p.dtype), packed[:, D:2 * D], packed[:, 2 * D:]


@pytest.mark.parametrize("l2", [0.0, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["rows", "packed"])
def test_commit_equals_jax_sparse_step(layout, dtype, l2):
    p, mu, nu, rows, scatter, g = _inputs(seed=len(layout) + len(dtype), dtype=dtype)
    want = _jax_step(layout, p, mu, nu, rows, scatter, g, l2)
    before = LA.adam_commit.launches
    got = [x.float().numpy() for x in _port_step(layout, p, mu, nu, rows, scatter, g, l2)]
    assert LA.adam_commit.launches == before           # no kernel on the CPU
    for name, gv, wv in zip(("mu", "nu"), got[1:], want[1:]):
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6, err_msg=name)
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6, err_msg="p")
    else:
        scale = np.maximum(np.abs(p.float().numpy()), np.abs(want[0])) + 1e-30
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert (np.abs(got[0] - want[0]) <= ulp).all(), np.abs(got[0] - want[0]).max()
    written = torch.zeros(N, dtype=torch.bool)
    written[scatter[scatter < N]] = True
    assert not np.array_equal(got[1][written.numpy()], mu[written.numpy()])   # the step moved mu
    for x, before_x in zip(got, (p.float().numpy(), mu, nu)):
        assert np.array_equal(x[~written.numpy()], before_x[~written.numpy()])


@pytest.mark.parametrize("layout", ["rows", "packed"])
def test_out_of_range_write_ids_leave_the_tables_bit_identical(layout):
    p, mu, nu, rows, _, g = _inputs(seed=5, dtype="float32")
    scatter = torch.tensor([N, N + 1, -1, -5, 2**40] * (N_IDS // 5) + [N] * (N_IDS % 5))
    got = _port_step(layout, p, mu, nu, rows, scatter, g, 1e-3)
    for x, want in zip(got, (p, torch.from_numpy(mu), torch.from_numpy(nu))):
        assert torch.equal(x, want)


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_packed_and_three_table_commits_bit_equal(l2):
    p, mu, nu, rows, scatter, g = _inputs(seed=9, dtype="float32")
    three = _port_step("rows", p, mu, nu, rows, scatter, g, l2)
    packed = _port_step("packed", p, mu, nu, rows, scatter, g, l2)
    for a, b in zip(three, packed):
        assert torch.equal(a, b)


def test_commit_rejects_what_the_kernel_does_not_take():
    tx = LA.LazyAdamTx(LR, 0.0)
    table, g = torch.zeros(10, 12), torch.zeros(3, 4)
    ids = torch.tensor([1, 2, 3])
    kw = dict(gathered=torch.zeros(3, 12))
    commit = lambda *a, **k: LA.adam_commit(tx, 0.1, 0.001, 0.0, *a, **k)  # noqa: E731
    with pytest.raises(TypeError, match="dtype"):
        commit(table, g, ids.int(), **kw)                    # int32 ids
    with pytest.raises(ValueError, match="contiguous"):
        commit(table, torch.zeros(4, 3).T, ids, **kw)
    with pytest.raises(ValueError, match="shape"):
        commit(table, torch.zeros(3, 5), ids, **kw)
    with pytest.raises(ValueError, match="3D"):
        commit(torch.zeros(10, 13), g, ids, gathered=torch.zeros(3, 13))
    with pytest.raises(ValueError, match="either"):
        commit(table, g, ids, gathered=kw["gathered"], rows=ids)
    with pytest.raises(ValueError, match="takes vals"):
        commit(torch.zeros(10, 4), g, ids, rows=ids)
    with pytest.raises(TypeError, match="dtype"):
        commit(torch.zeros(10, 4, dtype=torch.float64), g, ids, vals=torch.zeros(3, 4), rows=ids,
               mu=torch.zeros(10, 4), nu=torch.zeros(10, 4))
    with pytest.raises(RuntimeError, match="no gradient"):
        commit(table.clone().requires_grad_(True), g, ids, **kw)
    assert torch.equal(commit(table, g[:0], ids[:0], gathered=kw["gathered"][:0]), table)  # R = 0
