"""Kernel B4 `scatter_rows`: the port's plain version (what its wrapper
runs for CPU tensors) against the JAX package's Pallas `scatter_rows` in
interpret mode, and against `.at[rows].set(block, mode="drop")` at widths
and types the Pallas kernel cannot take. A row copy moves bits, so every
comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu.ops.pallas_scatter import scatter_rows as jax_scatter_rows
from rechorus_tpu_torch.ops.cuda_scatter import scatter_rows, scatter_rows_plain


def _case(N, D, R, seed, drop=(3, 11)):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    rows = rng.permutation(N)[:R].astype(np.int32)
    for j in drop:
        rows[j] = N                       # dropped
    block = rng.normal(size=(R, D)).astype(np.float32)
    return table, rows, block


@pytest.mark.parametrize("N,D,R,rpb", [(1000, 128, 64, 16), (257, 256, 96, 32), (300, 128, 37, 16)])
def test_plain_equals_pallas_scatter_rows(N, D, R, rpb):
    """The shapes of tests/test_pallas_scatter.py, the ragged R = 37 included."""
    table, rows, block = _case(N, D, R, seed=R)
    want = np.asarray(jax_scatter_rows(jnp.asarray(table), jnp.asarray(rows),
                                       jnp.asarray(block), rpb=rpb))
    got = scatter_rows_plain(torch.from_numpy(table.copy()), torch.from_numpy(rows),
                             torch.from_numpy(block))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [64, 192, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_equals_xla_drop_scatter(D, dtype):
    """Widths off the 128-lane tile and bf16: against XLA's own scatter.
    On CPU tensors the wrapper takes the plain version, in place."""
    table, rows, block = _case(500, D, 120, seed=D)
    rows[5] = -1                          # below the range: dropped too
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jt, jb = jnp.asarray(table).astype(jdt), jnp.asarray(block).astype(jdt)
    keep = rows >= 0                      # jax wraps negative ids; the port drops them
    want = np.asarray(jt.at[jnp.asarray(rows[keep])].set(jb[keep], mode="drop").astype(jnp.float32))
    t = torch.from_numpy(table.copy()).to(tdt)
    out = scatter_rows(t, torch.from_numpy(rows), torch.from_numpy(block).to(tdt))
    assert out is t and scatter_rows.launches == 0     # in place; no kernel on the CPU
    np.testing.assert_array_equal(t.float().numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t, b = torch.zeros(10, 4), torch.zeros(3, 4)
    rows = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(TypeError):
        scatter_rows(t, rows, b.double())
    with pytest.raises(TypeError):
        scatter_rows(t, rows.long(), b)
    with pytest.raises(ValueError):
        scatter_rows(t, rows, torch.zeros(3, 5))
    with pytest.raises(ValueError):
        scatter_rows(t.T, rows, torch.zeros(3, 10))
    with pytest.raises(RuntimeError):
        scatter_rows(t.clone().requires_grad_(True), rows, b)
    assert torch.equal(scatter_rows(t, rows[:0], b[:0]), torch.zeros(10, 4))   # R = 0
