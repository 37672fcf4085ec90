"""The port's scaling layer (rechorus_tpu_torch/parallel/) against the
JAX package's (rechorus_tpu/parallel/) on the CPU: its rules (row pad,
the sharding rule, the tables each model class shards), `tiled_ge_count`,
the sharded catalog top-k and ranks of a 4-rank gloo world against the
JAX package's 8-device CPU mesh, a 2 x 2 world's SASRec from the JAX
package's parameters against the JAX package's mesh evaluation, and every
registered class's forward and loss on a model axis of 2 against its
one-process forward.

Worlds are gloo CPU ranks started by tests/_torch_mesh.py (spawn, one
intra-op thread each, a file store under the test's temporary directory).
"""
import argparse
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.batching import LazyRows as JLazyRows
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.ops import topk as JT
from rechorus_tpu.parallel import mesh as JM
from rechorus_tpu.parallel import topk as JPT
from rechorus_tpu_torch import weights
from rechorus_tpu_torch.ops import topk as TT
from rechorus_tpu_torch.parallel import mesh as M

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh as TM  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_row_pad():
    yield
    M.set_table_row_pad(1)
    JM.set_table_row_pad(1)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    TM.make_corpora(root)
    return root


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_pad_rows_matches_jax(m):
    for pkg in (M, JM):
        pkg.set_table_row_pad(m)
    for n in (1, 2, 1023, 1024, 2048, 2049, 1_000_001):
        assert M.pad_rows(n) == JM.pad_rows(n), (m, n)
    assert M.get_table_row_pad() == JM.get_table_row_pad() == m


# (flax leaf path, shape, model axis)
SPEC_CASES = [
    (("i_embeddings", "embedding"), (2049, 32), 2),       # does not divide: replicated
    (("i_embeddings", "embedding"), (2050, 32), 2),
    (("i_embeddings", "embedding"), (1023, 32), 1),       # below MIN_ROWS_TO_SHARD
    (("i_embeddings", "embedding"), (1024, 32), 4),
    (("u_embeddings", "embedding"), (3000, 8), 3),
    (("bank", "fused_table", "embedding"), (4096, 8), 8),
    (("item_embeddings",), (2048, 16), 2),                 # a raw 'embedding' parameter
    (("item_bias",), (2048, 1), 2),                        # no 'embedding' in the path
    (("i_embeddings", "embedding"), (2048,), 2),           # not 2-D
    (("mlp_0", "kernel"), (4096, 64), 2),
]


@pytest.mark.parametrize("path,shape,m", SPEC_CASES)
def test_param_spec_matches_jax(path, shape, m, caplog):
    with caplog.at_level(logging.WARNING):
        got = M.param_spec(path, shape, m)
    port_warned = any("not divisible" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = JM.param_spec(path, jnp.zeros(shape), model_size=m)
    jax_warned = any("not divisible" in r.message for r in caplog.records)
    assert (got == "model") == (want == P("model", None)), (path, shape, m)
    assert port_warned == jax_warned


_JAX_CORPORA = {}


def _jax_sharded_paths(root, case):
    """The flax paths the JAX rule row-shards of `case`'s model built
    under a row pad of 2 (`jax.eval_shape` of its init: nothing computed)."""
    name, kw = ("Chorus", dict(stage=2, model_path=os.path.join(root, "chorus", "m.bin"))) \
        if case == "Chorus-2" else (case, {})
    args = TM.model_args(root, name, **kw)
    JM.set_table_row_pad(2)
    cls = jregistry.get_model(name)
    key = (root, cls.reader, args.dataset)
    if key not in _JAX_CORPORA:
        _JAX_CORPORA[key] = jregistry.get_reader(cls.reader)(argparse.Namespace(**vars(args)))
    corpus = _JAX_CORPORA[key]
    model = cls.from_args(args, corpus)
    batcher = jget_batcher(cls.batcher)(corpus, model, "train", args)
    arrays = {k: jnp.asarray(v.materialize(0, 2)) if isinstance(v, JLazyRows) else v
              for k, v in batcher.device_arrays().items()}

    def init(key, arrays, idx):   # the JAX runner's init_state trace
        return model.init({"params": key, "dropout": key},
                          batcher.train_feed(arrays, idx, key), training=True)

    shapes = jax.eval_shape(init, jax.random.key(0), arrays, jnp.arange(2, dtype=jnp.int32))
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = tuple(p.key for p in path)
        if JM.param_spec(keys, leaf, model_size=2) == P("model", None):
            out.add(keys)
    return out


@pytest.mark.parametrize("case", TM.class_names())
def test_sharded_tables_match_the_jax_rule(corpora, case):
    """For every registered class over a 1,101-item catalog on a model
    axis of 2, the tables the port row-shards are the ones the JAX rule
    row-shards, mapped through weights.FLAX_TO_TORCH."""
    M.set_table_row_pad(2)
    _, model, _ = TM.build(corpora, case)
    port = {weights.flax_leaf_path(model.registered_name, k, dict(model.named_parameters())[k])
            for k in M.sharded_keys(model, 2)}
    want = _jax_sharded_paths(corpora, case)
    assert port == want
    if case not in ("POP", "LightGCN", "LightGCNImpression"):
        assert port, "a catalog of 1,101 items row-shards some table"


@pytest.mark.parametrize("name", ["NeuMF", "BUIR", "SLRCPlus"])
def test_load_reconciles_only_the_row_pad(corpora, name):
    """A checkpoint written under row pad 1 loads into a model under row
    pad 4: each padded table (`embed`'s, BUIR's targets) takes its live
    rows and keeps its dead tail, and a scalar stored as one element
    (SLRCPlus's `global_alpha` in a flax file) loads as torch loads it. A
    table of another catalog size, a dense layer of another width, or a
    dead tail as long as the pad raises, as does a padded row count in a
    model under no pad."""
    _, whole, _ = TM.build(corpora, name)
    whole.init_weights(torch.Generator().manual_seed(1))
    sd = {k: v.clone() for k, v in whole.state_dict().items()}
    live = M.live_rows(whole)
    assert live, "the model has padded tables"
    M.set_table_row_pad(4)
    _, padded, _ = TM.build(corpora, name)
    tail = {k: padded.state_dict()[k][n:].clone() for k, n in live.items()}
    assert any(len(t) for t in tail.values()), "some table has dead rows under pad 4"
    M.load_full_state_dict(padded, {k: v.reshape(1) if v.dim() == 0 else v for k, v in sd.items()})
    got = padded.state_dict()
    for k, v in sd.items():
        n = live.get(k)
        torch.testing.assert_close(got[k][:n] if n else got[k], v[:n] if n else v, rtol=0, atol=0)
        if n:
            torch.testing.assert_close(got[k][n:], tail[k], rtol=0, atol=0)
    table = max(live, key=live.get)           # an item table
    dense = next((k for k, v in sd.items() if k not in live and v.dim() == 2), None)
    n = live[table]
    bad = {
        "another catalog": {table: torch.zeros((n - 1,) + sd[table].shape[1:])},
        "a dead tail as long as the pad": {table: torch.zeros((n + 4,) + sd[table].shape[1:])},
    }
    if dense is not None:
        bad["a dense layer of another width"] = {
            dense: torch.zeros((sd[dense].shape[0] + 1,) + sd[dense].shape[1:])}
    for why, change in bad.items():
        with pytest.raises(RuntimeError):
            M.load_full_state_dict(padded, {**sd, **change})
            pytest.fail(why)
    M.set_table_row_pad(1)
    with pytest.raises(RuntimeError, match="rows"):
        M.load_full_state_dict(whole, {**sd, table: torch.zeros((n + 1,) + sd[table].shape[1:])})


# -------------------------------------------------------- tiled_ge_count
GE_CASES = {  # case -> (N rows of the shard, col_offset, n_valid, target inside clicked)
    "offset": (300, 700, None, False),
    "offset-n_valid": (300, 700, 900, False),
    "target-in-clicked": (300, 600, 880, True),
    "first-shard": (512, 0, 500, True),
}


@pytest.mark.parametrize("case", list(GE_CASES))
def test_tiled_ge_count_matches_jax(case):
    N, off, nv, in_clicked = GE_CASES[case]
    rng = np.random.default_rng(3)
    B, D, Mc = 12, 16, 6
    u = rng.normal(size=(B, D)).astype(np.float32)
    table = rng.normal(size=(N, D)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32)
    hi = off + N if nv is None else min(nv, off + N)
    target = rng.integers(max(off, 1), hi, size=B).astype(np.int32)
    clicked = rng.integers(0, off + N + 50, size=(B, Mc)).astype(np.int32)
    if in_clicked:
        clicked[:, 0] = target
    loc = target - off
    tscore = (u * table[loc]).sum(1) + bias[loc] - 0.05
    JT.PALLAS = "on"
    try:
        want = JT.tiled_ge_count(jnp.asarray(u), jnp.asarray(table), jnp.asarray(tscore),
                                 bias=jnp.asarray(bias), clicked_rows=jnp.asarray(clicked),
                                 n_valid=nv, col_offset=off, target_col=jnp.asarray(target))
    finally:
        JT.PALLAS = "auto"
    t = torch.from_numpy
    got = TT.tiled_ge_count(t(u), t(table), t(tscore), bias=t(bias), clicked_rows=t(clicked),
                            n_valid=nv, col_offset=off, target_col=t(target))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).min()


# ------------------------------------------- sharded catalog top-k and ranks
@pytest.fixture(scope="module")
def catalog_case():
    """tests/test_parallel.py's inputs: 512 rows, the target in each row's
    clicked set."""
    rng = np.random.default_rng(5)
    B, N, d, k = 16, 512, 32, 10
    clicked = np.zeros((B, 7), dtype=np.int32)
    target = rng.integers(1, N, size=(B,)).astype(np.int32)
    for b in range(B):
        clicked[b, 0] = target[b]
        clicked[b, 1:] = rng.choice(np.arange(1, N), size=6, replace=False)
    return dict(u=rng.normal(size=(B, d)).astype(np.float32),
                table=rng.normal(size=(N, d)).astype(np.float32),
                bias=rng.normal(size=(N,)).astype(np.float32), clicked=clicked,
                target=target), k


@pytest.fixture(scope="module")
def port_catalog(catalog_case, tmp_path_factory):
    inputs, k = catalog_case
    return TM.run_world(TM.sharded_catalog, 4, str(tmp_path_factory.mktemp("catalog")), inputs, k)


def _jax_catalog(inputs, k, n_devices, mp, tiled, monkeypatch):
    mesh = JM.make_mesh(n_devices, model_parallel=mp)
    if tiled:
        monkeypatch.setattr(JPT, "MIN_ROWS_FOR_TILED", 64)
    j = {key: jnp.asarray(v) for key, v in inputs.items()}
    table = jax.device_put(j["table"], NamedSharding(mesh, P("model", None)))
    with jax.set_mesh(mesh):
        v, i = JPT.sharded_catalog_topk(j["u"], table, k, mesh, clicked_rows=j["clicked"],
                                        item_bias=j["bias"])
        r = JPT.sharded_catalog_ranks(j["u"], table, j["target"], mesh, j["clicked"],
                                      item_bias=j["bias"])
    return np.asarray(v), np.asarray(i), np.asarray(r)


@pytest.mark.parametrize("shape,n_devices,mp", [("1x4", 8, 4), ("2x2", 4, 2)])
@pytest.mark.parametrize("branch", ["dense", "tiled"])
def test_sharded_catalog_matches_jax_mesh(port_catalog, catalog_case, shape, n_devices, mp,
                                          branch, monkeypatch):
    """A 4-rank gloo world (model axis 4, then a 2 x 2 mesh) against the
    JAX package's sharded_catalog_topk / _ranks on its CPU mesh of the
    same model axis: values at rtol 1e-5 / atol 1e-6, ids equal except on
    ties, ranks exactly equal; every rank returns the same."""
    inputs, k = catalog_case
    want_v, want_i, want_r = _jax_catalog(inputs, k, n_devices, mp, branch == "tiled", monkeypatch)
    for rank_out in port_catalog:
        v, i, r = rank_out[(shape, branch)]
        np.testing.assert_allclose(v, want_v, rtol=1e-5, atol=1e-6)
        diff = i != want_i
        if diff.any():   # ties only
            np.testing.assert_allclose(v[diff], want_v[diff], rtol=1e-5)
        np.testing.assert_array_equal(r, want_r)
    assert not np.isin(want_i, [0]).any()


# --------------------------------------- a 2 x 2 SASRec from JAX parameters
@pytest.fixture(scope="module")
def sasrec_pair(corpora, tmp_path_factory):
    """The JAX package's SASRec on a 2 x 2 mesh of its CPU devices, its
    parameters redrawn at O(0.3) (tables built under a row pad of 2): its
    dev ranks, --test_all test ranks, and one step's loss and gradients on
    a fixed train feed; and the same from a 2 x 2 gloo world of the port
    loaded with those parameters."""
    tmp = str(tmp_path_factory.mktemp("sasrec"))
    args = TM.model_args(corpora, "SASRec", data_parallel=2, model_parallel=2)
    cls = jregistry.get_model("SASRec")
    runner = jregistry.get_runner(cls.runner)(args)        # the mesh; row pad 2
    corpus = jregistry.get_reader(cls.reader)(args)
    model = cls.from_args(args, corpus)
    b = {p: jget_batcher(cls.batcher)(corpus, model, p, args) for p in ("train", "dev")}
    model_t = model.clone(test_all=1)     # the test split over the whole catalog
    tb = jget_batcher(cls.batcher)(corpus, model_t, "test", args)
    state = runner.init_state(model, b["train"], 0)
    rng = np.random.default_rng(11)
    params = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.3).astype(np.float32),
                          jax.device_get(state.params))
    state = state.replace(params=jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                                              state.params, params))
    dev = runner.predict_ranks(state, model, b["dev"], runner.place_arrays(b["dev"].device_arrays()),
                               "dev")
    test = runner.predict_ranks(state, model_t, tb, runner.place_arrays(tb.device_arrays()), "test")
    feed = jax.device_get(b["train"].train_feed(b["train"].device_arrays(),
                                                jnp.arange(16, dtype=jnp.int32), jax.random.key(4)))

    def loss_fn(p):
        return model.loss(model.apply({"params": p}, feed, training=True,
                                      rngs={"dropout": jax.random.key(0)}), feed)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    JM.set_table_row_pad(1)
    state_file = os.path.join(tmp, "params.pt")
    torch.save(weights.from_flax_params(params, "SASRec"), state_file)
    feed = {k: np.asarray(v) for k, v in feed.items()}
    port = TM.run_world(TM.sasrec_from_jax, 4, os.path.join(tmp, "world"), corpora, state_file,
                        feed)
    want = dict(dev=np.asarray(dev), test=np.asarray(test), loss=float(loss),
                grads={k: v.numpy() for k, v in
                       weights.from_flax_params(jax.device_get(grads), "SASRec").items()})
    return want, port


def test_sasrec_mesh_ranks_match_jax_mesh(sasrec_pair):
    want, port = sasrec_pair
    assert runner_ranks_ok(want["dev"]) and runner_ranks_ok(want["test"])
    for got in port:
        np.testing.assert_array_equal(got["dev"], want["dev"])
        np.testing.assert_array_equal(got["test"], want["test"])
    assert want["test"].max() > 100, "the --test_all ranks span the catalog"


def runner_ranks_ok(r):
    return r.min() >= 1 and len(r) > 0


def test_sasrec_mesh_step_matches_jax(sasrec_pair):
    """One step's loss (the data ranks' rows averaged) and whole
    gradients (sharded tables gathered) on one fixed feed, at 1e-5."""
    want, port = sasrec_pair
    for got in port:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-5, atol=1e-5, err_msg=k)


# --------------------------------------- every class on a model axis of 2
@pytest.fixture(scope="module")
def every_class(corpora, tmp_path_factory):
    return TM.run_world(TM.every_class_on_model_axis, 2, str(tmp_path_factory.mktemp("every")),
                        corpora, TM.class_names())


@pytest.mark.parametrize("case", TM.class_names())
def test_every_class_forward_on_model_axis_matches_one_process(every_class, case):
    """Each class's eval forward and training loss with its tables
    row-sharded over a model axis of 2 equal the same weights' forward
    and loss whole, at 1e-5, on both ranks: no read of a sharded table
    bypasses the masked gather or the whole-table accessor."""
    for rank_out in every_class:
        (want_pred, want_loss), keys, (pred, loss) = rank_out[case]
        np.testing.assert_allclose(pred, want_pred, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)


# ------------------------------------ every class's step on a data axis of 2
@pytest.fixture(scope="module")
def every_class_step(corpora, tmp_path_factory):
    return TM.run_world(TM.every_class_step_on_data_axis, 2,
                        str(tmp_path_factory.mktemp("every_step")), corpora, TM.class_names())


@pytest.mark.parametrize("case", TM.class_names())
def test_every_class_step_on_data_axis_matches_one_process(every_class_step, case):
    """One training step of each class on a data axis of 2 -- each rank
    its half of the batch, the gradients averaged over 'data', or summed
    for a loss that sums its rows -- equals the whole batch's step in one
    process: the loss and every parameter's change (SGD at lr 1, so the
    gradient), at 1e-5, on both ranks."""
    for rank_out in every_class_step:
        (want_loss, want), (loss, got) = rank_out[case]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
        assert set(got) == set(want)
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g, rtol=1e-5, atol=1e-5, err_msg=k)
