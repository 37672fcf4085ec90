"""The port's serving slice as a whole against the JAX package: the
Grocery reader, BPRMF with flax weights carried over, `ServeIndex` on
the dense and the tiled route, exact and approx, and the Grocery
full-catalog ranks.

The JAX side takes its Pallas kernel route (`topk.PALLAS = "on"`,
interpret mode on the CPU); the port runs on the CPU (`device="cpu"`),
where its kernel wrappers use their plain versions. Tolerances are
those of tests/test_serve.py:49-52.
"""
import argparse
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rechorus_tpu.data.readers import BaseReader as JaxReader
from rechorus_tpu.models.general.bprmf import BPRMF as FlaxBPRMF
from rechorus_tpu.ops import metrics as jmetrics
from rechorus_tpu.ops import pallas_kernels as PK
from rechorus_tpu.ops import topk as JT
from rechorus_tpu.serve import ServeIndex as JaxServeIndex
from rechorus_tpu_torch import weights
from rechorus_tpu_torch.data.readers import BaseReader
from rechorus_tpu_torch.models.base import BaseModel
from rechorus_tpu_torch.models.general.bprmf import BPRMF
from rechorus_tpu_torch.ops import metrics as tmetrics
from rechorus_tpu_torch.ops.cuda_kernels import catalog_ranks
from rechorus_tpu_torch.serve import ServeIndex, dense_catalog_scores

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
EMB = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    return argparse.Namespace(path=DATA, dataset="Grocery_and_Gourmet_Food", sep="\t",
                              emb_size=EMB, num_neg=1, dropout=0.0, test_all=1, **kw)


@pytest.fixture(scope="module")
def grocery():
    """(port reader, JAX reader, flax BPRMF, flax params, torch BPRMF)."""
    corpus, jcorpus = BaseReader(_args()), JaxReader(_args())
    fmodel = FlaxBPRMF(user_num=jcorpus.n_users, item_num=jcorpus.n_items, emb_size=EMB)
    feed = {"user_id": jnp.zeros((2,), jnp.int32), "item_id": jnp.zeros((2, 3), jnp.int32)}
    params = jax.device_get(fmodel.init(jax.random.key(0), feed)["params"])
    model = BPRMF.from_args(_args(), corpus)
    model.load_state_dict(weights.from_flax_params(params))
    return corpus, jcorpus, fmodel, params, model.eval()


def test_reader_matches_jax(grocery):
    corpus, jcorpus = grocery[:2]
    assert (corpus.n_users, corpus.n_items) == (jcorpus.n_users, jcorpus.n_items)
    for residual in (False, True):
        np.testing.assert_array_equal(corpus.clicked_matrix(include_residual=residual),
                                      jcorpus.clicked_matrix(include_residual=residual))
    for key in ("train", "dev", "test"):
        np.testing.assert_array_equal(corpus.data_df[key][["user_id", "item_id", "time"]].to_numpy(),
                                      jcorpus.data_df[key][["user_id", "item_id", "time"]].to_numpy())


def test_bprmf_forward_matches_flax(grocery):
    corpus, _, fmodel, params, model = grocery
    assert (model.user_num, model.item_num, model.emb_size) == (corpus.n_users, corpus.n_items, EMB)
    rng = np.random.default_rng(10)
    users = rng.integers(1, corpus.n_users, size=6).astype(np.int32)
    items = rng.integers(1, corpus.n_items, size=(6, 5)).astype(np.int32)
    jfeed = {"user_id": jnp.asarray(users), "item_id": jnp.asarray(items)}
    tfeed = {"user_id": torch.from_numpy(users).long(), "item_id": torch.from_numpy(items).long()}
    with torch.no_grad():
        for catalog, key in ((False, "prediction"), (True, "u_v")):
            ref = fmodel.apply({"params": params}, jfeed, catalog=catalog)[key]
            got = model(tfeed, catalog=catalog)[key]
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_from_flax_params_rejects_unmapped_trees():
    with pytest.raises(KeyError, match="unmapped"):
        weights.from_flax_params({"u_embeddings": {"embedding": np.zeros((2, 2))},
                                  "i_embeddings": {"embedding": np.zeros((2, 2))},
                                  "extra": {"kernel": np.zeros(2)}})


def _assert_serve_match(items_s, scores_s, items_r, scores_r):
    np.testing.assert_allclose(scores_s, scores_r, rtol=2e-5, atol=1e-5)
    diff = items_s != items_r
    if diff.any():  # ties only
        np.testing.assert_allclose(scores_s[diff], scores_r[diff], rtol=2e-5)


def test_serve_dense_route_matches_jax(grocery):
    corpus, jcorpus, fmodel, params, model = grocery
    users = np.arange(1, 33, dtype=np.int32)
    idx = ServeIndex.build(model, corpus, k=100, device="cpu")
    assert idx.grouped is None                       # 8.7k items: dense route
    items_s, scores_s = idx.query(users)
    jidx = JaxServeIndex.build(fmodel, types.SimpleNamespace(params=params), jcorpus, k=100)
    items_r, scores_r = jidx.query(users)
    assert items_s.dtype == np.int32 and items_s.shape == (32, 100)
    _assert_serve_match(items_s, scores_s, items_r, scores_r)
    clicked = corpus.clicked_matrix(include_residual=True)
    for b, u in enumerate(users):
        assert not set(items_s[b].tolist()) & set(clicked[u][clicked[u] > 0].tolist())


def test_serve_tiled_route_matches_jax():
    rng = np.random.default_rng(11)
    n_users, N, D = 40, 16384 + 37, 8
    u_table = rng.normal(size=(n_users, D)).astype(np.float32)
    i_table = rng.normal(size=(N, D)).astype(np.float32)
    clicked = rng.integers(0, N, size=(n_users, 6)).astype(np.int32)
    # clicked exclusion must bite: each user's best item is clicked
    clicked[:, 0] = np.argmax(u_table @ i_table[: N - 5].T, axis=1)
    users = np.arange(16, dtype=np.int32)
    idx = ServeIndex.from_tables(u_table, i_table, clicked=clicked, n_items=N - 5, k=50,
                                 device="cpu")
    assert idx.grouped is not None
    items_s, scores_s = idx.query(users)
    JT.PALLAS = "on"
    try:
        jidx = JaxServeIndex.from_tables(u_table, i_table, clicked=clicked, n_items=N - 5, k=50)
        assert jidx.grouped is not None
        items_r, scores_r = jidx.query(users)
    finally:
        JT.PALLAS = "auto"
    _assert_serve_match(items_s, scores_s, items_r, scores_r)
    assert not (items_s == clicked[users, :1]).any()
    assert ((items_s > 0) & (items_s < N - 5)).all()


@pytest.mark.parametrize("route,N", [("dense", 12000), ("tiled", 16384 + 37)])
def test_serve_approx_lane_recalls_the_jax_result(route, N):
    """`ServeIndex(approx=True)` on both routes: the bins reduce (L < the
    selected axis), recall against the JAX package's approx lane (an exact
    top-k on the CPU) is at least the target, every score is its id's
    exact score, and no clicked or dead id is served."""
    from rechorus_tpu_torch.ops import cuda_topk as CT

    rng = np.random.default_rng(12)
    n_users, D, k, recall = 40, 8, 50, 0.9
    u_table = rng.normal(size=(n_users, D)).astype(np.float32)
    i_table = rng.normal(size=(N, D)).astype(np.float32)
    clicked = rng.integers(1, N, size=(n_users, 6)).astype(np.int32)
    clicked[:, 0] = np.argmax(u_table @ i_table[1: N - 5].T, axis=1) + 1
    users = np.arange(32, dtype=np.int32)
    idx = ServeIndex.from_tables(u_table, i_table, clicked=clicked, n_items=N - 5, k=k,
                                 approx=True, recall_target=recall, device="cpu")
    assert (idx.grouped is not None) == (route == "tiled") and idx.approx
    axis = N if route == "dense" else -(-N // (16 * 128)) * 128
    assert CT.approx_bins(axis, k + 6, recall) < axis
    items_s, scores_s = idx.query(users)
    JT.PALLAS = "on"
    try:
        jidx = JaxServeIndex.from_tables(u_table, i_table, clicked=clicked, n_items=N - 5, k=k,
                                         approx=True, recall_target=recall)
        items_r, _ = jidx.query(users)
    finally:
        JT.PALLAS = "auto"
    recalled = np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                        for a, b in zip(items_s, np.asarray(items_r))])
    assert recall <= recalled < 1.0
    exact = (u_table[users][:, None, :] * i_table[items_s]).sum(-1)
    np.testing.assert_allclose(scores_s, exact, rtol=1e-5, atol=1e-5)
    assert not (items_s[:, :, None] == clicked[users][:, None, :]).any()
    assert ((items_s > 0) & (items_s < N - 5)).all()


def test_grocery_catalog_ranks_match_jax(grocery):
    corpus, jcorpus, fmodel, params, model = grocery
    test = corpus.data_df["test"].iloc[:64]
    users = test["user_id"].to_numpy().copy()
    target = test["item_id"].to_numpy().astype(np.int32)
    clicked = corpus.clicked_matrix(include_residual=True)[users]
    with torch.no_grad():
        u = model({"user_id": torch.from_numpy(users)}, catalog=True)["u_v"]
        scores = dense_catalog_scores(u, model.i_embeddings.weight, None, corpus.n_items)
        ranks = catalog_ranks(scores, torch.from_numpy(target), torch.from_numpy(clicked)).numpy()
    ju = fmodel.apply({"params": params}, {"user_id": jnp.asarray(users)}, catalog=True)["u_v"]
    jscores = ju @ jnp.asarray(params["i_embeddings"]["embedding"]).T
    jranks = np.asarray(PK.catalog_ranks(jscores, jnp.asarray(target), jnp.asarray(clicked)))
    np.testing.assert_array_equal(ranks, jranks)
    topk, metrics = [5, 10, 20, 50], ["HR", "NDCG"]
    assert tmetrics.evaluate_topk_from_ranks(ranks, topk, metrics) == \
        jmetrics.evaluate_topk_from_ranks(jranks, topk, metrics)


class _BiasedMF(nn.Module):
    supports_catalog = True
    catalog_table = ("i_embeddings",)
    catalog_item_table = BaseModel.catalog_item_table   # what ServeIndex.build reads

    def __init__(self, n_users, n_items, dim, bias_rows):
        super().__init__()
        self.u_embeddings = nn.Embedding(n_users, dim)
        self.i_embeddings = nn.Embedding(n_items, dim)
        self.i_bias = nn.Embedding(bias_rows, 1)


def test_build_reads_item_bias_and_rejects_non_catalog_models():
    model = _BiasedMF(5, 30, 4, bias_rows=30)
    idx = ServeIndex.build(model, k=3, device="cpu")
    np.testing.assert_array_equal(idx.i_bias.numpy(), model.i_bias.weight.detach().numpy()[:, 0])
    items, scores = idx.query(np.arange(5))
    u = model.u_embeddings.weight.detach()
    ref = u @ model.i_embeddings.weight.detach().T + idx.i_bias[None]
    ref[:, 0] = float("-inf")
    np.testing.assert_allclose(scores, torch.topk(ref, 3).values.numpy(), rtol=2e-5, atol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        ServeIndex.build(_BiasedMF(5, 30, 4, bias_rows=29), device="cpu")
    with pytest.raises(ValueError, match="from_tables"):
        ServeIndex.build(nn.Linear(2, 2), device="cpu")


def test_default_device_is_the_card():
    u, i = np.zeros((4, 2), np.float32), np.zeros((10, 2), np.float32)
    if torch.cuda.is_available():
        assert ServeIndex.from_tables(u, i).i_table.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeIndex.from_tables(u, i)
