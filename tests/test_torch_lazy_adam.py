"""The lazy-Adam lanes of the port against the JAX package's functions,
and the lanes against each other inside the port.

Both runners take five BPRMF steps on a small synthetic corpus from the
same weights, with the same row indices and the same negatives (injected
as `_ep_neg_items`, so neither sampler draws). The candidate permutation
differs between the two, but predictions are restored to the original
order before the loss and BPRMF scores each candidate on its own. The
port runs on the CPU, where `scatter_rows` takes its plain version.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.batching import get_batcher as jax_get_batcher
from rechorus_tpu.data.synthetic import make_topk_dataset
from rechorus_tpu.ops import lazy_adam as JLA
from rechorus_tpu.ops import layers as jlayers
from rechorus_tpu_torch import weights
from rechorus_tpu_torch.data.batching import GeneralBatcher
from rechorus_tpu_torch.data.readers import BaseReader
from rechorus_tpu_torch.models.general.bprmf import BPRMF
from rechorus_tpu_torch.ops import lazy_adam as LA
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.runners.base import BaseRunner

STEPS, BATCH, EMB = 5, 32, 16
LANES = {  # name: runner flags
    "packed": dict(lazy_emb_adam=1, sparse_emb_grad=1, packed_opt_rows=1),
    "three_scatter": dict(lazy_emb_adam=1, sparse_emb_grad=1, packed_opt_rows=0),
    "dense_grad_lazy": dict(lazy_emb_adam=1, sparse_emb_grad=0),
    "dense": dict(lazy_emb_adam=0),
}
U, I = "u_embeddings.weight", "i_embeddings.weight"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_lazy")
    make_topk_dataset(str(root / "Synth"), n_users=50, n_items=80, n_per_user=9)
    return root


@pytest.fixture(autouse=True)
def _reset_table_dtype():
    yield
    jlayers.set_table_dtype(None)
    tlayers.set_table_dtype(None)


def _ns(data_root, **kw):
    ns = BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    ns.__dict__.update(path=str(data_root), dataset="Synth", sep="\t", emb_size=EMB, num_neg=2,
                       dropout=0.0, test_all=0, gpu="", random_seed=7, model_path="", lr=1e-2,
                       l2=1e-4, batch_size=BATCH, buffer=1, ckpt_format="flax")
    ns.__dict__.update(kw)
    return ns


def _feeds(n_train, n_items):
    rng = np.random.default_rng(11)
    neg = rng.integers(1, n_items, size=(n_train, 2))
    idx = [rng.integers(0, n_train, size=BATCH) for _ in range(STEPS)]   # duplicates welcome
    return neg, idx


def _jax_steps(ns):
    """Five steps of the JAX runner's own step function; packed leaves are
    packed before and unpacked after, as its epoch does."""
    model_cls = jregistry.get_model("BPRMF")
    corpus = jregistry.get_reader(model_cls.reader)(ns)
    model = model_cls.from_args(ns, corpus)
    runner = jregistry.get_runner(model_cls.runner)(ns)
    batcher = jax_get_batcher(model_cls.batcher)(corpus, model, "train", ns)
    arrays = runner.place_arrays(batcher.device_arrays())
    neg, idx = _feeds(len(batcher), corpus.n_items)
    arrays["_ep_neg_items"] = jnp.asarray(neg, jnp.int32)
    state = runner.init_state(model, batcher, ns.random_seed)
    start = jax.device_get(state.params)
    box = {"paths": set()}
    step_fn = runner._build_step_fn(model, batcher, runner._tx, box)
    dtypes = {}
    if runner._packed_lane_ok():
        paths = list(runner._lazy_specs)
        params, opt, dtypes = JLA.pack_lazy_leaves(state.params, state.opt_state, paths)
        state = state.replace(params=params, opt_state=opt)
        box["paths"] = set(dtypes)
    losses = []
    keys = jax.random.split(jax.random.key(0), STEPS)
    for i, k in zip(idx, keys):
        state, loss = step_fn(arrays, state, (jnp.asarray(i, jnp.int32), k))
        losses.append(float(loss))
    if dtypes:
        params, opt = JLA.unpack_lazy_leaves(state.params, state.opt_state, dtypes)
        state = state.replace(params=params, opt_state=opt)
    opt = state.opt_state
    if not hasattr(opt, "mu"):   # optax chain: find the Adam state
        opt = [s for s in jax.tree.leaves(opt, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    f32 = lambda tree: jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)  # noqa: E731
    return start, dict(params=weights.from_flax_params(f32(state.params)),
                       mu=weights.from_flax_params(f32(opt.mu)),
                       nu=weights.from_flax_params(f32(opt.nu)),
                       count=int(opt.count), losses=losses)


def _torch_steps(ns, start):
    corpus = BaseReader(ns)
    runner = BaseRunner(ns)
    model = BPRMF.from_args(ns, corpus)
    batcher = GeneralBatcher(corpus, model, "train", ns)
    arrays = batcher.device_arrays(runner.device)
    neg, idx = _feeds(len(batcher), corpus.n_items)
    arrays["_ep_neg_items"] = torch.from_numpy(neg)
    state = runner.init_state(model, ns.random_seed)
    f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), start)
    model.load_state_dict(weights.from_flax_params(f32))
    gen = torch.Generator().manual_seed(0)
    model.train()
    if runner._packed_lane_ok():
        runner._pack(state, batcher.train_feed(arrays, torch.from_numpy(idx[0]), gen))
        assert set(state.packed_dtypes) == {U, I}
    losses = [float(runner.train_step(state, batcher, arrays, torch.from_numpy(i), gen))
              for i in idx]
    runner._unpack(state)
    assert all(p.grad is None for p in model.parameters())
    opt = state.opt_state
    mu, nu = (opt.slots["mu"], opt.slots["nu"]) if hasattr(opt, "slots") else (opt.mu, opt.nu)
    return dict(params={k: v.detach().float() for k, v in model.state_dict().items()},
                mu=mu, nu=nu, count=opt.count, losses=losses, dtypes={k: v.dtype for k, v in
                                                                     model.state_dict().items()})


@pytest.mark.parametrize("lane", list(LANES))
def test_five_steps_equal_jax_f32(data_root, lane):
    """1e-6 absolute on parameters of O(0.01..0.1) and moments of O(1e-3):
    the two sides differ by f32 rounding (bias corrections computed in
    f64 here and f32 there, sums in another order in the backward)."""
    ns = _ns(data_root, **LANES[lane])
    start, want = _jax_steps(ns)
    got = _torch_steps(ns, start)
    assert got["count"] == want["count"] == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-6)
    for part in ("params", "mu", "nu"):
        for k in (U, I):
            np.testing.assert_allclose(got[part][k].numpy(), want[part][k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{lane}/{part}/{k}")
    assert float((got["params"][I] - weights.from_flax_params(
        jax.tree.map(np.asarray, start))[I]).abs().max()) > 1e-3     # the steps moved the table


@pytest.mark.parametrize("lane", ["packed", "three_scatter", "dense_grad_lazy"])
def test_five_steps_equal_jax_bf16_tables(data_root, lane):
    """--bf16_emb: each table value within one bf16 ulp, taken at the
    larger of its start and end magnitude (a value that lands near a
    rounding boundary may round the other way, and the ulp that counts is
    that of the operands of `p - update`, not of a result that cancelled);
    the f32 moments within 1e-4, since a table value one ulp apart feeds
    the next step's gradients. The packed lane rides in f32 and rounds
    once."""
    ns = _ns(data_root, bf16_emb=1, **LANES[lane])
    start, want = _jax_steps(ns)
    got = _torch_steps(ns, start)
    assert got["dtypes"][U] == got["dtypes"][I] == torch.bfloat16
    assert got["mu"][I].dtype == torch.float32 and got["count"] == want["count"] == STEPS
    first = weights.from_flax_params(jax.tree.map(lambda x: np.asarray(x, np.float32), start))
    for k in (U, I):
        g, w = got["params"][k].numpy(), want["params"][k].numpy()
        scale = np.maximum(np.abs(first[k].numpy()), np.abs(w)) + 1e-30
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert (np.abs(g - w) <= ulp).all(), f"{lane}/params/{k}: {np.abs(g - w).max()}"
        assert (g == w).mean() > 0.9
        for part in ("mu", "nu"):
            np.testing.assert_allclose(got[part][k].numpy(), want[part][k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{lane}/{part}/{k}")


def test_packed_and_three_scatter_lanes_bit_equal(data_root):
    start, _ = _jax_steps(_ns(data_root, **LANES["dense"]))
    packed = _torch_steps(_ns(data_root, **LANES["packed"]), start)
    three = _torch_steps(_ns(data_root, **LANES["three_scatter"]), start)
    assert packed["losses"] == three["losses"]
    for part in ("params", "mu", "nu"):
        for k in (U, I):
            assert torch.equal(packed[part][k], three[part][k]), f"{part}/{k}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_is_identity(dtype):
    g = torch.Generator().manual_seed(1)
    params = {"emb.weight": torch.randn(6, 4, generator=g).to(dtype), "w": torch.ones(3)}
    state = LA.LazyAdamState(count=5, mu={"emb.weight": torch.randn(6, 4, generator=g), "w": torch.ones(3)},
                             nu={"emb.weight": torch.rand(6, 4, generator=g), "w": torch.ones(3)})
    pp, ps, dt = LA.pack_lazy_leaves(params, state, ["emb.weight"])
    assert pp["emb.weight"].shape == (6, 12) and pp["emb.weight"].dtype == torch.float32
    assert ps.mu["emb.weight"].shape == (0,) and ps.count == 5
    up, us = LA.unpack_lazy_leaves(pp, ps, dt)
    assert up["emb.weight"].dtype == dtype
    for got, want in [(up, params), (us.mu, state.mu), (us.nu, state.nu)]:
        for k in want:
            assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_unique_rows_equals_jax(seed):
    ids = np.random.default_rng(seed).integers(0, 40, size=64)
    ids[:3] = 39                                   # the pad value is also touched
    want_rows, want_scatter = JLA.unique_rows(jnp.asarray(ids, jnp.int32), 40)
    rows, scatter = LA.unique_rows(torch.from_numpy(ids), 40)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(scatter.numpy(), np.asarray(want_scatter))
    want_map = JLA.row_pos_map(want_rows, want_scatter, 40)
    np.testing.assert_array_equal(LA.row_pos_map(rows, scatter, 40).numpy(), np.asarray(want_map))


def test_unique_rows_hashed_invariants():
    """Which duplicate wins is not specified; that exactly one does is."""
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 50, size=200))
    rows, scatter, pos_map = LA.unique_rows_hashed(ids, 50)
    R = ids.shape[0]
    win = pos_map[ids] == torch.arange(R, dtype=torch.int32)
    for i in ids.unique().tolist():
        assert int(win[ids == i].sum()) == 1                      # one winner per distinct id
    assert torch.equal(scatter[win], ids[win]) and bool((scatter[~win] == 50).all())
    assert torch.equal(rows[win], ids[win]) and bool((rows[~win] == 49).all())
    touched = torch.zeros(50, dtype=torch.bool)
    touched[ids] = True
    assert bool((pos_map[~touched] == R).all()) and bool((pos_map[touched] < R).all())
    assert torch.equal(ids[pos_map[ids].long()], ids)             # every occurrence finds its slot


@pytest.mark.parametrize("with_pos_map", [True, False])
def test_table_embed_sparse_lookup_forward_and_row_gradient(with_pos_map):
    """Inside the context the forward equals the dense gather, the
    gradient arrives row-aggregated on the [R, D] block, and no [N, D]
    gradient exists anywhere."""
    torch.manual_seed(0)
    table = tlayers.TableEmbed(30, 4)
    ids = torch.tensor([[3, 7, 3], [9, 3, 29]])
    want = table(ids)
    if with_pos_map:
        rows, _, pos_map = LA.unique_rows_hashed(ids, 30)
    else:
        rows, scatter = LA.unique_rows(ids, 30)
        pos_map = None
    vals = table.weight.detach()[rows].clone().requires_grad_(True)
    tlayers.set_sparse_lookup({id(table.weight): (rows, vals, None, pos_map)})
    try:
        got = table(ids)
        # an id outside `rows` falls back to a detached table gather
        assert torch.equal(table(torch.tensor([11])), table.weight.detach()[[11]])
    finally:
        tlayers.set_sparse_lookup(None)
    assert torch.equal(got, want)
    (got * torch.arange(6.0).reshape(2, 3, 1)).sum().backward()
    assert table.weight.grad is None and vals.grad.shape == (6, 4)
    per_id = {3: 0.0 + 2.0 + 4.0, 7: 1.0, 9: 3.0, 29: 5.0}
    for i, w in per_id.items():
        slots = (rows == i).nonzero().ravel()
        assert float(vals.grad[slots].sum(0)[0]) == w             # all of an id's gradient, once
    want.sum().backward()                                         # outside: the dense [N, D] gradient
    assert table.weight.grad.shape == (30, 4)


class _BypassBPRMF(BPRMF):
    """Reads the item table raw, past TableEmbed's sparse lookup."""

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        u_v = self.u_embeddings(feed["user_id"])
        return {"prediction": (u_v[:, None, :] * self.i_embeddings.weight[feed["item_id"]]).sum(-1)}


@pytest.mark.parametrize("flag", [0, 1])
def test_debug_nan_placeholder_surfaces_a_bypass_read(data_root, flag):
    ns = _ns(data_root, debug_nan_placeholder=flag, **LANES["packed"])
    corpus, runner = BaseReader(ns), BaseRunner(ns)
    model = _BypassBPRMF.from_args(ns, corpus)
    batcher = GeneralBatcher(corpus, model, "train", ns)
    arrays = batcher.device_arrays(runner.device)
    state = runner.init_state(model, 0)
    loss = runner.fit(state, batcher, arrays, 1, max_steps=3)
    assert np.isnan(loss) if flag else np.isfinite(loss)


def test_lazy_specs_that_match_nothing_raise(data_root):
    ns = _ns(data_root, **LANES["packed"])
    corpus, runner = BaseReader(ns), BaseRunner(ns)
    model = BPRMF.from_args(ns, corpus)
    model.lazy_table_specs = lambda: {"no_such.weight": ("user_id",)}
    batcher = GeneralBatcher(corpus, model, "train", ns)
    state = runner.init_state(model, 0)
    with pytest.raises(ValueError, match="lazy_table_specs matched no"):
        runner.fit(state, batcher, batcher.device_arrays(runner.device), 1, max_steps=1)
