"""The rest of the general family of the port (POP, NeuMF, DirectAU,
LightGCN, BUIR with BUIRRunner, CFKG with CFKGBatcher) against the JAX
package on the same inputs: forward, loss and gradients against the flax
twins with the same weights (`weights.from_flax_params`), LightGCN's edge
list and propagated tables on Grocery, BUIR's EMA, CFKG's feeds and the KG
negative sampler, the losses on their own, and the metric lift of the
JAX package's end-to-end tests (tests/test_e2e_general.py,
tests/test_e2e_kg.py) through the port's runner on the CPU.

Small sizes: D = 16. Weights are redrawn from numpy at O(0.3), so a
mismatch cannot hide under tiny init values. Tolerance 1e-5 absolute
(f32 sums of O(1) values in two libraries), 1e-6 for the EMA.
"""
import argparse
import logging
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.batching import _kg_corruption as jax_kg_corruption
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.data.readers import BaseReader as JaxBaseReader
from rechorus_tpu.data.readers import KGReader as JaxKGReader
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.models.general.lightgcn import build_edges as jax_build_edges
from rechorus_tpu.ops import kg as jkg
from rechorus_tpu.ops import losses as jlosses
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import CFKGBatcher, _kg_corruption, get_batcher
from rechorus_tpu_torch.data.readers import BaseReader, KGReader
from rechorus_tpu_torch.models.general.lightgcn import build_edges
from rechorus_tpu_torch.ops import kg as kg_ops
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.runners import base as tbase

ATOL = 1e-5
EMB = 16
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GROCERY = "Grocery_and_Gourmet_Food"
MODELS = {  # name: (model flags, candidates per train row)
    "POP": (dict(), 2),
    "NeuMF": (dict(layers="[16, 8]"), 2),
    "DirectAU": (dict(gamma=0.3), 1),
    "LightGCN": (dict(n_layers=3), 2),
    "BUIR": (dict(momentum=0.9), 1),
    "CFKG": (dict(margin=1.0, include_attr=1), 4),
}


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
def _reset_globals():
    yield
    tlayers.set_table_dtype(None)
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One general corpus (the JAX tests' make_topk_dataset, by the port's
    generator) and one KG corpus (make_kg_dataset), read by both packages."""
    root = tmp_path_factory.mktemp("general")
    synthetic.make_topk_dataset(str(root / "Synth"))
    synthetic.make_kg_dataset(str(root / "SynthKG"))
    return root


def _margs(name, **kw):
    base = dict(num_neg=1, dropout=0.0, test_all=0, emb_size=EMB, layers="[64]", gamma=1.0,
                n_layers=3, momentum=0.995, margin=0.0, include_attr=0)
    return argparse.Namespace(**{**base, **MODELS[name][0], **kw})


@pytest.fixture(scope="module")
def corpora(roots):
    """{reader name: (port reader, JAX reader)}."""
    general = argparse.Namespace(path=str(roots), dataset="Synth", sep="\t")
    kg = argparse.Namespace(path=str(roots), dataset="SynthKG", sep="\t", include_attr=1)
    return {"BaseReader": (BaseReader(general), JaxBaseReader(general)),
            "KGReader": (KGReader(kg), JaxKGReader(kg))}


def _feed(name, corpus, B=24, seed=0):
    """A numpy feed of B train rows (ids in range) for both packages."""
    rng = np.random.default_rng(seed)
    C = MODELS[name][1]
    if name == "CFKG":
        n_ent = corpus.n_users + corpus.n_entities
        return {"head_id": rng.integers(0, n_ent, size=(B, C)),
                "tail_id": rng.integers(0, n_ent, size=(B, C)),
                "relation_id": rng.integers(0, corpus.n_relations, size=(B, C))}
    return {"user_id": rng.integers(0, corpus.n_users, size=B),
            "item_id": rng.integers(0, corpus.n_items, size=(B, C))}


def _redraw(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.3),
                        tree)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request, corpora):
    """(name, flax model, flax variables with redrawn params, torch model
    with the same state, numpy feed)."""
    name = request.param
    reader = "KGReader" if name == "CFKG" else "BaseReader"
    corpus, jcorpus = corpora[reader]
    args = _margs(name)
    jmodel = jregistry.get_model(name).from_args(args, jcorpus)
    feed = _feed(name, corpus)
    jfeed = {k: jnp.asarray(v, jnp.int32) for k, v in feed.items()}
    variables = jax.device_get(jmodel.init(jax.random.key(0), jfeed, training=True))
    variables = dict(variables, params=_redraw(variables["params"], 1))
    model = registry.get_model(name).from_args(args, corpus)
    model.load_state_dict(weights.from_flax_params(variables["params"], name), strict=name != "BUIR")
    if name == "BUIR":
        # random targets, so that the loss reads them
        variables["target"] = _redraw(variables["target"], 2)
        model.user_target.copy_(torch.from_numpy(variables["target"]["user_target"]))
        model.item_target.copy_(torch.from_numpy(variables["target"]["item_target"]))
    return name, jmodel, variables, model, feed


def _tfeed(feed):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in feed.items()}


def test_forward_equals_flax(pair):
    name, jmodel, variables, model, feed = pair
    jfeed = {k: jnp.asarray(v, jnp.int32) for k, v in feed.items()}
    want = np.asarray(jmodel.apply(variables, jfeed, training=False)["prediction"])
    with torch.no_grad():
        got = model(_tfeed(feed))["prediction"].numpy()
    assert got.shape == want.shape == (24, MODELS[name][1])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if name != "POP":
        # the propagation averages over degrees: LightGCN's scores are smaller
        floor = 0.01 if name == "LightGCN" else 0.1
        assert np.abs(want).max() > floor, "scores above the init's tiny ones"


def test_loss_and_gradients_equal_flax(pair):
    """The training forward, the loss and every parameter's gradient (POP's
    dummy parameter has none: its loss does not read it)."""
    name, jmodel, variables, model, feed = pair
    jfeed = {k: jnp.asarray(v, jnp.int32) for k, v in feed.items()}
    rest = {k: v for k, v in variables.items() if k != "params"}

    def jloss(p):
        return jmodel.loss(jmodel.apply({"params": p, **rest}, jfeed, training=True), jfeed)

    jl, jgrads = jax.value_and_grad(jloss)(variables["params"])
    model.zero_grad()
    tfeed = _tfeed(feed)
    loss = model.loss(model(tfeed, training=True), tfeed)
    if name == "POP":
        assert not loss.requires_grad and abs(float(loss) - float(jl)) <= ATOL
        return
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= ATOL
    want_g = weights.from_flax_params(jax.device_get(jgrads), name)
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    assert max(float(g.abs().max()) for g in got_g.values()) > 1e-3
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=0, atol=ATOL, err_msg=k)


def test_param_count_round_trip_and_l2_exempt_set(pair):
    name, jmodel, variables, model, _ = pair
    params = variables["params"]
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    back = weights.to_flax_params(dict(model.named_parameters()), name)
    flat, flat_back = (flax.traverse_util.flatten_dict(t) for t in (params, back))
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))
    jmask = flax.traverse_util.flatten_dict(jbase._decay_mask(params))
    tmask = tbase._decay_mask(dict(model.named_parameters()))
    assert len(jmask) == len(tmask)
    for path, decayed in jmask.items():
        assert tmask[weights._torch_leaf(name, path)[0]] == decayed, path


def test_lazy_tables_equal_jax(pair):
    name, jmodel, _, model, _ = pair
    jspecs = jmodel.lazy_table_specs()
    want = {".".join(path[:-1]) + ".weight": feeds for path, feeds in jspecs.items()}
    assert model.lazy_table_specs() == want
    assert (name == "LightGCN") == (want == {})


def test_initialisers_follow_flax():
    """xavier_normal (DirectAU, BUIR), xavier_uniform (LightGCN) and BUIR's
    N(0, 1) predictor bias, at the scale of flax's initialisers."""
    gen = torch.Generator().manual_seed(0)
    nu, ni = 3000, 2000
    for name, table, want_std in (("DirectAU", "u_embeddings", np.sqrt(2 / (nu + EMB))),
                                  ("BUIR", "user_online", np.sqrt(2 / (nu + EMB))),
                                  ("LightGCN", "user_emb", np.sqrt(2 / (nu + EMB)))):
        model = registry.get_model(name)(user_num=nu, item_num=ni, emb_size=EMB)
        model.init_weights(gen)
        w = getattr(model, table)
        w = (w.weight if hasattr(w, "weight") else w).detach()
        assert float(w.std()) == pytest.approx(want_std, rel=0.05), name
        if name == "LightGCN":
            assert float(w.abs().max()) <= np.sqrt(6 / (nu + EMB))
        else:
            assert float(w.abs().max()) <= 2 * want_std / 0.8796 + 1e-6
    buir = registry.get_model("BUIR")(user_num=nu, item_num=ni, emb_size=256)
    buir.init_weights(gen)
    assert float(buir.predictor.bias.detach().std()) == pytest.approx(1.0, rel=0.15)


def test_neumf_dropout_uses_the_step_generator(corpora):
    corpus = corpora["BaseReader"][0]
    model = registry.get_model("NeuMF").from_args(_margs("NeuMF", dropout=0.5), corpus)
    model.init_weights(torch.Generator().manual_seed(0))
    feed = _tfeed(_feed("NeuMF", corpus))
    with torch.no_grad():
        a = model(feed, training=True, gen=torch.Generator().manual_seed(5))["prediction"]
        b = model(feed, training=True, gen=torch.Generator().manual_seed(5))["prediction"]
        c = model(feed, training=True, gen=torch.Generator().manual_seed(6))["prediction"]
        e = model(feed)["prediction"]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, e)


# ---------------------------------------------------------------- losses
def test_alignment_uniformity_and_margin_losses_equal_jax():
    rng = np.random.default_rng(3)
    u, i = (rng.normal(size=(33, 8)).astype(np.float32) for _ in range(2))
    u[5] = u[9]                                                 # a repeated row: distance 0
    pos, neg = rng.normal(size=40).astype(np.float32), rng.normal(size=40).astype(np.float32)
    cases = [("alignment", lambda a, b: jlosses.alignment_loss(a, b), losses.alignment_loss, (u, i)),
             ("uniformity", lambda a: jlosses.uniformity_loss(a), losses.uniformity_loss, (u,)),
             ("margin", lambda a, b: jlosses.margin_rank_loss(a, b, 0.7),
              lambda a, b: losses.margin_rank_loss(a, b, 0.7), (pos, neg))]
    for what, jfn, fn, args in cases:
        want, want_g = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
            *(jnp.asarray(a) for a in args))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
        got = fn(*ts)
        got.backward()
        assert abs(float(got) - float(want)) <= 1e-6, what
        for t, g in zip(ts, want_g):
            assert torch.isfinite(t.grad).all(), what
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=1e-6, err_msg=what)


# -------------------------------------------------------------- LightGCN
@pytest.fixture(scope="module")
def grocery():
    args = argparse.Namespace(path=DATA, dataset=GROCERY, sep="\t")
    return BaseReader(args), JaxBaseReader(args)


def test_lightgcn_edges_equal_jax_on_grocery(grocery):
    corpus, jcorpus = grocery
    got = build_edges(corpus.n_users, corpus.n_items, corpus.train_clicked_set)
    want = jax_build_edges(jcorpus.n_users, jcorpus.n_items, jcorpus.train_clicked_set)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["rows"]) == 2 * len(corpus.data_df["train"].drop_duplicates(["user_id", "item_id"]))


def test_lightgcn_propagated_tables_equal_jax_on_grocery(grocery):
    """The propagated [users | items] tables (the catalog protocol's u_v and
    item table) at 1e-5, weights from numpy at the xavier scale times 10."""
    corpus, jcorpus = grocery
    args = _margs("LightGCN")
    jmodel = jregistry.get_model("LightGCN").from_args(args, jcorpus)
    feed = {"user_id": np.arange(1, 65), "item_id": np.arange(1, 129).reshape(64, 2)}
    jfeed = {k: jnp.asarray(v, jnp.int32) for k, v in feed.items()}
    variables = jax.device_get(jmodel.init(jax.random.key(0), jfeed))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.1).astype(np.float32),
                          variables["params"])
    out = jmodel.apply({**variables, "params": params}, jfeed, catalog=True)
    model = registry.get_model("LightGCN").from_args(args, corpus)
    model.load_state_dict(weights.from_flax_params(params, "LightGCN"))
    with torch.no_grad():
        u_v = model(_tfeed(feed), catalog=True)["u_v"].numpy()
        table = model.catalog_item_table()
        again = model.catalog_item_table()
    assert table.shape == (corpus.n_items, EMB) and table.is_contiguous()
    assert again is not table and torch.equal(again, table)    # the no-grad cache
    np.testing.assert_allclose(table.numpy(), np.asarray(out["i_table"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(u_v, np.asarray(out["u_v"]), rtol=0, atol=ATOL)
    assert np.abs(u_v).max() > 0.01
    # a parameter update invalidates the cache
    with torch.no_grad():
        model.item_emb.add_(1.0)
        assert not torch.equal(model.catalog_item_table(), table)


# ------------------------------------------------------------------ BUIR
def test_buir_targets_after_20_ema_steps_equal_jax():
    rng = np.random.default_rng(7)
    model = registry.get_model("BUIR")(user_num=30, item_num=50, emb_size=EMB, momentum=0.9)
    jmodel = jregistry.get_model("BUIR")(user_num=30, item_num=50, emb_size=EMB, momentum=0.9)
    model.init_weights(torch.Generator().manual_seed(0))
    model.post_init_state()
    assert torch.equal(model.user_target, model.user_online.weight.detach())
    assert model.user_target.data_ptr() != model.user_online.weight.data_ptr()
    extra = {"target": {"user_target": model.user_target.numpy().copy(),
                        "item_target": model.item_target.numpy().copy()}}
    for _ in range(20):
        new = {"user_online": {"embedding": rng.normal(size=(30, EMB)).astype(np.float32)},
               "item_online": {"embedding": rng.normal(size=(50, EMB)).astype(np.float32)}}
        extra = jmodel.ema_update(new, extra)
        with torch.no_grad():
            model.user_online.weight.copy_(torch.from_numpy(new["user_online"]["embedding"]))
            model.item_online.weight.copy_(torch.from_numpy(new["item_online"]["embedding"]))
        model.ema_update()
    for key in ("user_target", "item_target"):
        np.testing.assert_allclose(getattr(model, key).numpy(), np.asarray(extra["target"][key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def _runner_args(**kw):
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    ns.__dict__.update(gpu="", random_seed=0, model_path="", lr=1e-2, batch_size=128,
                       eval_batch_size=128, topk="5,10", check_epoch=0)
    ns.__dict__.update(kw)
    return ns


def test_buir_runner_keeps_the_packed_lane_off_and_moves_the_targets(corpora):
    """BUIRRunner overrides `_post_update`, so the lazy lane commits in the
    three-table layout (the module's tables stay current), and after every
    step the targets are the EMA of the online tables."""
    corpus = corpora["BaseReader"][0]
    args = _runner_args(lazy_emb_adam=1)
    model = registry.get_model("BUIR").from_args(_margs("BUIR"), corpus)
    runner = registry.get_runner("BUIRRunner")(args)
    batcher = get_batcher(model.batcher)(corpus, model, "train", args)
    arrays = batcher.device_arrays(runner.device)
    state = runner.init_state(model, 0)
    assert runner._lazy_specs and not runner._packed_lane_ok()
    assert tbase.BaseRunner(args)._lazy_specs == {}               # before init_state
    assert torch.equal(model.user_target, model.user_online.weight)
    before = model.user_target.clone()
    seen = []
    real_ema = model.ema_update

    def ema():
        seen.append((model.user_target.clone(), model.user_online.weight.detach().clone()))
        real_ema()
        t0, w = seen[-1]
        torch.testing.assert_close(model.user_target, t0 * model.momentum + w * (1 - model.momentum),
                                   rtol=0, atol=0)

    model.ema_update = ema
    runner.fit(state, batcher, arrays, 1, max_steps=3)
    assert len(seen) == 3 and not state.packed_dtypes
    assert not torch.equal(model.user_target, before)
    # the DirectAU counterpart takes the packed lane
    runner2 = tbase.BaseRunner(args)
    runner2.init_state(registry.get_model("DirectAU").from_args(_margs("DirectAU"), corpus), 0)
    assert runner2._packed_lane_ok()


# ------------------------------------------------------------------ CFKG
def _cfkg_batchers(corpora, phase, test_all=0):
    corpus, jcorpus = corpora["KGReader"]
    args = _margs("CFKG", test_all=test_all)
    jmodel = jregistry.get_model("CFKG").from_args(args, jcorpus)
    model = registry.get_model("CFKG").from_args(args, corpus)
    return CFKGBatcher(corpus, model, phase, args), jget_batcher("cfkg")(jcorpus, jmodel, phase, args)


@pytest.mark.parametrize("phase,test_all", [("train", 0), ("dev", 0), ("test", 1)])
def test_cfkg_batcher_arrays_and_feeds_equal_jax(corpora, phase, test_all):
    b, jb = _cfkg_batchers(corpora, phase, test_all)
    assert b.arrays.keys() == jb.arrays.keys() and len(b) == len(jb)
    for k in b.arrays:
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    idx = np.sort(np.random.default_rng(0).choice(len(b), min(96, len(b)), replace=False))
    arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
    tidx, jidx = torch.from_numpy(idx), jnp.asarray(idx, jnp.int32)
    if phase == "train":
        feed = b.train_feed(arrays, tidx, torch.Generator().manual_seed(0))
        jfeed = jb.train_feed(jarrays, jidx, jax.random.key(0))
        # the non-random columns: heads 0-2, tails 0, 1 and 3, the relations
        cols = {"head_id": [0, 1, 2], "tail_id": [0, 1, 3], "relation_id": [0, 1, 2, 3]}
        for k, keep in cols.items():
            assert feed[k].shape == tuple(jfeed[k].shape) == (len(idx), 4), k
            np.testing.assert_array_equal(feed[k].numpy()[:, keep], np.asarray(jfeed[k])[:, keep],
                                          err_msg=k)
        assert "item_id" not in feed
        return
    feeds = [(b.eval_feed(arrays, tidx), jb.eval_feed(jarrays, jidx))]
    if test_all:
        cands = np.random.default_rng(1).integers(0, b.corpus.n_items, (len(idx), 37))
        feeds.append((b.eval_feed(arrays, tidx, cands=torch.from_numpy(cands)),
                      jb.eval_feed(jarrays, jidx, cands=jnp.asarray(cands, jnp.int32))))
    for feed, jfeed in feeds:
        keys = {k for k in jfeed if hasattr(jfeed[k], "shape")}
        assert keys == {k for k in feed if torch.is_tensor(feed[k])}
        for k in keys:
            np.testing.assert_array_equal(feed[k].numpy(), np.asarray(jfeed[k]), err_msg=k)


def test_cfkg_negatives_avoid_known_triplets_and_clicked_items(corpora):
    """Buy rows: the corrupted tail is an item the head user did not click,
    the corrupted head a user who did not click the tail; KG rows: no
    corruption forms a known triplet; all in range."""
    b, _ = _cfkg_batchers(corpora, "train")
    corpus = b.corpus
    arrays = b.device_arrays("cpu")
    idx = torch.arange(len(b))
    feed = b.train_feed(arrays, idx, torch.Generator().manual_seed(3))
    nu = corpus.n_users
    h, t, r = arrays["kg_head"], arrays["kg_tail"], arrays["kg_relation"]
    neg_t = feed["tail_id"][:, 2] - nu
    neg_h = feed["head_id"][:, 3] - torch.where(r > 0, nu, 0)
    buy = r == 0
    assert buy.any() and (~buy).any()
    assert ((neg_t[buy] >= 1) & (neg_t[buy] < corpus.n_items)).all()
    assert ((neg_h[buy] >= 1) & (neg_h[buy] < corpus.n_users)).all()
    assert ((neg_t[~buy] >= 1) & (neg_t[~buy] < corpus.n_entities)).all()
    assert ((neg_h[~buy] >= 1) & (neg_h[~buy] < corpus.n_entities)).all()
    clicked = arrays["_clicked"]
    assert not (clicked[h[buy]] == neg_t[buy][:, None]).any()
    assert not (clicked[neg_h[buy]] == t[buy][:, None]).any()
    keys = arrays["_triplet_keys"]
    n_rel, n_ent = corpus.n_relations, corpus.n_entities
    assert not kg_ops.is_member(keys, h[~buy], r[~buy], neg_t[~buy], n_rel, n_ent).any()
    assert not kg_ops.is_member(keys, neg_h[~buy], r[~buy], t[~buy], n_rel, n_ent).any()
    assert kg_ops.is_member(keys, h[~buy], r[~buy], t[~buy], n_rel, n_ent).all()


def test_sample_kg_negatives_and_kg_corruption(corpora):
    """`kg.sample_kg_negatives`: every negative in [1, hi) and none a known
    triplet (the member table against the JAX package's `is_member`);
    `_kg_corruption`'s non-random columns equal the JAX package's, and
    `swap_feed` swaps heads and tails."""
    corpus, jcorpus = corpora["KGReader"]
    rel = corpus.relation_df
    n_rel, n_ent = corpus.n_relations, corpus.n_entities
    h, r, t = (torch.from_numpy(rel[c].to_numpy().copy()) for c in ("head", "relation", "tail"))
    table = torch.from_numpy(corpus.member_table())
    neg_h, neg_t = kg_ops.sample_kg_negatives(torch.Generator().manual_seed(0), h, r, t, table,
                                              n_rel, n_ent, hi_tail=n_ent, hi_head=corpus.n_items)
    assert ((neg_t >= 1) & (neg_t < n_ent)).all() and ((neg_h >= 1) & (neg_h < corpus.n_items)).all()
    jtable = jnp.asarray(jcorpus.member_table())
    for a, b_, c in ((h, r, neg_t), (neg_h, r, t)):
        assert not np.asarray(jkg.is_member(jtable, *(jnp.asarray(x.numpy(), jnp.int32)
                                                      for x in (a, b_, c)), n_rel, n_ent)).any()
    b, jb = _cfkg_batchers(corpora, "train")
    b.kg_neg_hi = jb.kg_neg_hi = n_ent
    arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
    idx = np.arange(0, len(rel), 3)
    for swap in (False, True):
        feed = _kg_corruption(b, arrays, torch.from_numpy(idx), torch.Generator().manual_seed(1), swap)
        jfeed = jax_kg_corruption(jb, jarrays, jnp.asarray(idx, jnp.int32), jax.random.key(1), swap)
        heads, tails = ("tail_id", "head_id") if swap else ("head_id", "tail_id")
        np.testing.assert_array_equal(feed[heads].numpy()[:, :3], np.asarray(jfeed[heads])[:, :3])
        np.testing.assert_array_equal(feed[tails].numpy()[:, [0, 1, 3]],
                                      np.asarray(jfeed[tails])[:, [0, 1, 3]])
        np.testing.assert_array_equal(feed["relation_id"].numpy(), np.asarray(jfeed["relation_id"]))
        assert not kg_ops.is_member(table, feed[heads][:, 0], feed["relation_id"][:, 2],
                                    feed[tails][:, 2], n_rel, n_ent).any()


def test_cfkg_ranks_and_export_take_candidate_columns(corpora, tmp_path):
    """A feed without `item_id`: the sampled ranks, the full-catalog ranks
    (dense route and, at a small chunk, the tiled forward), and the
    top-k's ids are the candidate columns (JAX runners/base.py:1102, :1111)."""
    corpus = corpora["KGReader"][0]
    runner = tbase.BaseRunner(_runner_args(eval_candidate_chunk=16))
    out = {}
    for test_all in (0, 1):
        model = registry.get_model("CFKG").from_args(_margs("CFKG", test_all=test_all), corpus)
        state = runner.init_state(model, 0)
        b = CFKGBatcher(corpus, model, "test", runner.args)
        arrays = b.device_arrays(runner.device)
        ranks = runner.predict_ranks(state, b, arrays, "test")
        items, scores = runner.predict_topk(state, b, arrays, "test", k=10)
        assert ranks.shape == (len(b),) and (ranks >= 1).all()
        assert items.shape == (len(b), 10) and (np.diff(scores, axis=1) <= 0).all()
        out[test_all] = (b, arrays, items, ranks)
    b, arrays, items, ranks = out[1]
    assert runner._use_tiled_forward(model, b, arrays)           # n_items > 4 x 16
    dense = tbase.BaseRunner(_runner_args())
    assert not dense._use_tiled_forward(model, b, arrays)
    np.testing.assert_array_equal(dense.predict_ranks(state, b, arrays, "test"), ranks)
    clicked = arrays["_clicked_all"][arrays["user_id"]].numpy()
    assert ((items >= 1) & (items < corpus.n_items)).all()
    assert not (items[:, :, None] == clicked[:, None, :]).any()


# ----------------------------------------------------- learning (e2e lift)
def _e2e_args(**kw):
    base = dict(epoch=8, early_stop=10, lr=1e-2, l2=0.0, batch_size=128, eval_batch_size=128,
                topk="5,10", random_seed=42, num_neg=1, dropout=0.0, test_all=0, emb_size=16)
    return _runner_args(**{**base, **kw})


def _run_model(corpus, name, args):
    model_cls = registry.get_model(name)
    model = model_cls.from_args(args, corpus)
    runner = registry.get_runner(model_cls.runner)(args)
    batchers = {p: get_batcher(model_cls.batcher)(corpus, model, p, args)
                for p in ("train", "dev", "test")}
    arrays = {p: b.device_arrays(runner.device) for p, b in batchers.items()}
    state = runner.init_state(model, args.random_seed)
    before = runner.evaluate(state, batchers["test"], arrays["test"], "test", [5], ["HR", "NDCG"])
    if args.epoch:
        state = runner.train(batchers, state, arrays)
    after = runner.evaluate(state, batchers["test"], arrays["test"], "test", [5], ["HR", "NDCG"])
    return before, after


@pytest.mark.parametrize("name,kw,lift", [
    ("NeuMF", dict(layers="[16]", epoch=3), None),             # test_e2e_general.py:54-57
    ("LightGCN", dict(n_layers=2, epoch=6), 0.4),               # :128-132
    ("BUIR", dict(momentum=0.95, epoch=4, lr=5e-3), None),      # :135-140
    ("DirectAU", dict(gamma=0.3, epoch=8, lr=1e-2), 0.0),       # :163-167
])
def test_general_models_learn(corpora, name, kw, lift):
    """The JAX package's end-to-end checks of the family, on its corpus:
    a finite HR@5 after training, and where it asks for one, a lift over
    the untrained model (and LightGCN's floor)."""
    before, after = _run_model(corpora["BaseReader"][0], name, _e2e_args(**kw))
    assert np.isfinite(after["HR@5"])
    if lift is not None:
        assert after["HR@5"] > before["HR@5"] and after["HR@5"] > lift


def test_pop_scores_by_train_popularity(corpora):
    """POP with --train 0 (test_e2e_general.py:60-68): its test HR@5 is that
    of ranking the candidates by their train counts (ties against the
    target), in [0, 1]."""
    corpus = corpora["BaseReader"][0]
    before, after = _run_model(corpus, "POP", _e2e_args(epoch=0))
    assert before == after and 0.0 <= after["HR@5"] <= 1.0
    pop = np.bincount(corpus.data_df["train"]["item_id"], minlength=corpus.n_items)
    test = corpus.data_df["test"]
    cands = np.concatenate([test["item_id"].to_numpy()[:, None], np.stack(test["neg_items"])], 1)
    ranks = (pop[cands] >= pop[cands[:, :1]]).sum(1)
    assert after["HR@5"] == pytest.approx((ranks <= 5).mean())


def test_cfkg_learns(corpora):
    """test_e2e_kg.py:197-201 on its attribute corpus."""
    before, after = _run_model(corpora["KGReader"][0], "CFKG",
                               _e2e_args(margin=1.0, epoch=10, lr=5e-3, include_attr=1))
    assert np.isfinite(after["HR@5"]) and after["HR@5"] > before["HR@5"]


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("name,flags", [
    ("POP", ["--train", "0"]),
    ("NeuMF", ["--layers", "[16]", "--dropout", "0.2", "--lazy_emb_adam", "1",
               "--debug_nan_placeholder", "1"]),
    ("DirectAU", ["--gamma", "0.3", "--lazy_emb_adam", "1", "--debug_nan_placeholder", "1"]),
    ("LightGCN", ["--n_layers", "2", "--test_all", "1"]),
    ("BUIR", ["--lazy_emb_adam", "1"]),
    ("CFKG", ["--include_attr", "1", "--margin", "1", "--lazy_emb_adam", "1",
              "--debug_nan_placeholder", "1"]),
])
def test_cli_trains_reloads_and_exports(roots, tmp_path, name, flags):
    """Each model through `python -m rechorus_tpu_torch.main` on the CPU:
    epochs logged with finite losses (the packed lane's stale tables are
    NaN-poisoned), the top-100 export, and `--load 1 --train 0` reproducing
    the test metrics."""
    import re

    import pandas as pd

    dataset = "SynthKG" if name == "CFKG" else "Synth"

    def run(tag, *extra):
        log = tmp_path / f"{tag}.log"
        port_main.build_parser_and_run([
            "--model_name", name, "--emb_size", "16", "--lr", "1e-2", "--batch_size", "64",
            "--dataset", dataset, "--path", str(roots), "--gpu", "", "--epoch", "3",
            "--log_file", str(log), "--model_path", str(tmp_path / "m.bin"), *flags, *extra])
        return log.read_text()

    text = run("train")
    losses_seen = [float(x) for x in re.findall(r"^Epoch \d+\s+loss=(\S+) ", text, re.M)]
    assert len(losses_seen) == (0 if name == "POP" else 3) and np.isfinite(losses_seen).all()
    test_after = re.search(r"^Test After Training: (\(.*\))$", text, re.M).group(1)
    export = pd.read_csv(roots / dataset / f"rec-{name}-test.csv", sep="\t")
    width = 100 if "--test_all" in flags else 20
    assert len(eval(export["rec_items"][0])) == width
    # POP trains nothing and saves no checkpoint: its rerun is the check
    reload = [] if name == "POP" else ["--load", "1", "--train", "0"]
    text2 = run("reload", *reload, "--save_final_results", "0")
    assert re.search(r"^Test Before Training: (\(.*\))$", text2, re.M).group(1) == test_after
