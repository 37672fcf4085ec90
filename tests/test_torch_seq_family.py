"""The rest of the sequential family in the port (TiSASRec, ComiRec,
SLRCPlus, Chorus in both stages, ContraRec with each encoder, ContraKDA,
TiMiRec in both stages) against the JAX package on the same inputs:
forward outputs, losses and gradients with the weights carried across
(`weights.from_flax_params`), `#params`, the flax -> torch -> flax round
trip and the L2-exempt set; `infonce` and `relational_intervals`; the
batchers' arrays and deterministic feeds (TiSAS, SLRC, Chorus, Contra,
ContraKDA) on a synthetic KG corpus and on the committed Grocery corpus;
the augmented views' invariants and the Beta draw's distribution; the
lr-scaled dense update against optax's chain; the lazy lane's refusals;
the two-stage flows through the CLI; and a metric lift per model.

Small sizes: D = 16, history 6, 1-2 layers of 2 heads. Weights are redrawn
from numpy at O(0.3) so that activations are O(1). Tolerance 1e-5
absolute for forward values, losses and gradients (f32 products and sums
in two libraries); batcher arrays and feeds are compared exactly, the
optimizer at the 1e-6 of the existing Adam test.
"""
import argparse
import logging
import os
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import readers as jreaders
from rechorus_tpu.data.batching import _beta_augment as jax_beta_augment
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.ops import kg as jkg
from rechorus_tpu.ops import losses as jlosses
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import readers, synthetic
from rechorus_tpu_torch.data.batching import beta_augment, beta_sample, get_batcher
from rechorus_tpu_torch.ops import kg as tkg
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.ops import losses as tlosses
from rechorus_tpu_torch.runners import base as tbase

ATOL = 1e-5
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GROCERY = "Grocery_and_Gourmet_Food"
FAMILY = ["TiSASRec", "ComiRec", "SLRCPlus", "Chorus", "ContraRec", "ContraKDA", "TiMiRec"]
BASE = dict(num_neg=2, dropout=0.0, test_all=0, emb_size=16, history_max=6, host_shard_input=0,
            gpu="", random_seed=0, dataset="SynthKG", time_scalar=86400 * 10,
            category_col="i_category_c", num_heads=2, attention_size=6, include_val=1)
# model case -> (registered name, overrides)
CASES = {
    "TiSASRec": ("TiSASRec", dict(num_layers=2, time_max=8)),
    "ComiRec": ("ComiRec", dict(attn_size=5, K=3)),
    "ComiRec-nopos": ("ComiRec", dict(attn_size=5, K=3, add_pos=0)),
    "SLRCPlus": ("SLRCPlus", dict()),
    "Chorus-1": ("Chorus", dict(stage=1)),
    "Chorus-2": ("Chorus", dict(stage=2)),
    "Chorus-2-GMF": ("Chorus", dict(stage=2, base_method="GMF")),
    "ContraRec-BERT4Rec": ("ContraRec", dict(encoder="BERT4Rec", ccc_temp=0.5)),
    "ContraRec-GRU4Rec": ("ContraRec", dict(encoder="GRU4Rec")),
    "ContraRec-Caser": ("ContraRec", dict(encoder="Caser", gamma=0.5)),
    "ContraKDA": ("ContraKDA", dict(num_layers=1, ccc_temp=0.5)),
    "TiMiRec-pretrain": ("TiMiRec", dict(stage="pretrain", K=3, attn_size=5)),
    "TiMiRec-finetune": ("TiMiRec", dict(stage="finetune", K=3, attn_size=5, temp=0.7)),
    "TiMiRec-finetune-notrm": ("TiMiRec", dict(stage="finetune", K=2, add_trm=0, add_pos=0)),
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


def _reader_args(root, dataset):
    return argparse.Namespace(path=str(root), dataset=dataset, sep="\t", include_attr=1,
                              t_scalar=60, n_dft=64 if dataset == GROCERY else 32, freq_rand=0,
                              regenerate=0)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_family")
    synthetic.make_kg_dataset(str(root / "SynthKG"), n_users=80, n_items=120, n_per_user=10)
    return root


@pytest.fixture(scope="module")
def synth(synth_root):
    """{reader name: (port reader, JAX reader)} over one KG corpus."""
    out = {}
    for name in ("SeqReader", "KGReader", "KDAReader"):
        args = _reader_args(synth_root, "SynthKG")
        out[name] = (getattr(readers, name)(args), getattr(jreaders, name)(args))
    return out


@pytest.fixture(scope="module")
def grocery(tmp_path_factory):
    """(port KGReader, JAX KGReader) of the committed Grocery corpus (a
    KGReader is a SeqReader: the sequential batchers take it too)."""
    root = tmp_path_factory.mktemp("family_grocery")
    os.makedirs(root / GROCERY)
    for f in ("train.csv", "dev.csv", "test.csv", "item_meta.csv"):
        os.symlink(os.path.join(DATA, GROCERY, f), root / GROCERY / f)
    args = _reader_args(root, GROCERY)
    args.include_attr = 0
    return readers.KGReader(args), jreaders.KGReader(args)


def _model_args(name, tmp="", **kw):
    """Every model flag at its default (both packages parse the same
    flags), then BASE and the overrides."""
    defaults = vars(registry.get_model(name).parse_model_args(argparse.ArgumentParser()).parse_args([]))
    args = argparse.Namespace(**{**defaults, **BASE, **kw})
    args.model_path = os.path.join(str(tmp), "m.bin") if tmp else ""
    return args


def _torch_feed(jfeed):
    out = {}
    for k, v in jfeed.items():
        if hasattr(v, "shape"):
            a = np.asarray(v)
            kind = {"i": np.int64, "u": np.int64, "b": bool}.get(a.dtype.kind, np.float32)
            out[k] = torch.from_numpy(a.astype(kind))
    return out


def _redraw(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.3), params)


def _permute(jfeed, aligned, seed):
    """The runner's anti-leak permutation, drawn once in numpy and applied
    to the JAX feed (item_id and the candidate-aligned keys), with the
    target's column in `_target_col`."""
    if "item_id" not in jfeed or np.asarray(jfeed["item_id"]).ndim != 2:
        return jfeed
    items = np.asarray(jfeed["item_id"])
    rng = np.random.default_rng(seed)
    pidx = np.argsort(rng.random(items.shape), axis=1)
    out = dict(jfeed)
    out["item_id"] = jnp.asarray(np.take_along_axis(items, pidx, axis=1))
    for k in aligned:
        if k in out:
            v = np.asarray(out[k])
            ix = pidx.reshape(pidx.shape + (1,) * (v.ndim - 2))
            out[k] = jnp.asarray(np.take_along_axis(v, ix, axis=1))
    out["_target_col"] = jnp.asarray(np.argsort(pidx, axis=1)[:, 0].astype(np.int32))
    return out


def _build(synth, tmp_path, case):
    """(JAX model, params, port model with the same weights, JAX train
    feed, torch train feed, JAX dev feed, torch dev feed)."""
    name, kw = CASES[case]
    jcls, cls = jregistry.get_model(name), registry.get_model(name)
    corpus, jcorpus = synth[cls.reader]
    args = _model_args(name, tmp_path, **kw)
    jmodel = jcls.from_args(args, jcorpus)
    model = cls.from_args(_model_args(name, tmp_path, **kw), corpus)
    jb = jget_batcher(jcls.batcher)(jcorpus, jmodel, "train", args)
    # one compiled program per JAX call: op-by-op dispatch costs minutes here
    jfeed = jax.jit(jb.train_feed)(jb.device_arrays(), jnp.arange(32, dtype=jnp.int32),
                                   jax.random.key(3))
    jfeed = _permute(jfeed, getattr(jmodel, "candidate_aligned_keys", ()), 4)
    if name == "TiSASRec":
        # O(1e9) times at odd gaps and a user without a positive gap
        # (0xFFFFFFFF): the interval buckets at their boundaries
        rng = np.random.default_rng(5)
        times = np.sort(rng.integers(10 ** 9, 15 * 10 ** 8, size=(32, BASE["history_max"])), axis=1)
        jfeed["history_times"] = jnp.asarray(times)
        mins = rng.integers(1, 3 * 10 ** 7, size=32)
        mins[:3] = 0xFFFFFFFF
        jfeed["user_min_intervals"] = jnp.asarray(mins)
    jdev_b = jget_batcher(jcls.batcher)(jcorpus, jmodel, "dev", args)
    jdev = jax.jit(jdev_b.eval_feed)(jdev_b.device_arrays(), jnp.arange(24, dtype=jnp.int32))
    init_feed = jdev if name == "Chorus" else jfeed
    params = jax.jit(lambda f: jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                           f, training=False))(init_feed)["params"]
    params = jax.device_get(_redraw(params, 1))
    model.load_state_dict(weights.from_flax_params(params, name), strict=True)
    return jmodel, params, model, jfeed, _torch_feed(jfeed), jdev, _torch_feed(jdev)


@pytest.fixture(scope="module", params=list(CASES))
def built(request, synth, tmp_path_factory):
    return (request.param,) + _build(synth, tmp_path_factory.mktemp("built"), request.param)


def test_forward_loss_and_gradients_equal_flax(built):
    case, jmodel, params, model, jfeed, tfeed, jdev, tdev = built
    name = CASES[case][0]
    rngs = {"dropout": jax.random.key(2)}
    want = jax.jit(lambda p, f: jmodel.apply({"params": p}, f, training=True, rngs=rngs))(params, jfeed)
    got = model(tfeed, training=True, gen=torch.Generator().manual_seed(0))
    assert set(want) == set(got), (set(want), set(got))
    for key in want:
        g, w = got[key].detach().numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)
    assert np.abs(np.asarray(want["prediction"])).max() > 0.1, "O(1) scores"

    def jloss(p):
        return jmodel.loss(jmodel.apply({"params": p}, jfeed, training=True, rngs=rngs), jfeed)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = model.loss(model(tfeed, training=True, gen=torch.Generator().manual_seed(0)), tfeed)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= ATOL, (float(loss), float(jl))
    want_g = weights.from_flax_params(jax.device_get(jgrads), name)
    got_g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    assert max(float(g.abs().max()) for g in got_g.values()) > 1e-3
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=0, atol=ATOL, err_msg=k)

    # evaluation: the dev feed's [target | negatives] scores
    want = np.asarray(jax.jit(lambda p, f: jmodel.apply({"params": p}, f, training=False))(
        params, jdev)["prediction"])
    with torch.no_grad():
        got = model(tdev)["prediction"].numpy()
    assert got.shape == want.shape == (24, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if name == "TiSASRec":       # the catalog protocol's user vector
        u = jmodel.apply({"params": params}, jdev, training=False, catalog=True)["u_v"]
        with torch.no_grad():
            np.testing.assert_allclose(model(tdev, catalog=True)["u_v"].numpy(), np.asarray(u),
                                       rtol=0, atol=ATOL)


def test_params_round_trip_and_l2_exempt_set(built):
    case, jmodel, params, model, *_ = built
    name = CASES[case][0]
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    back = weights.to_flax_params(model.state_dict(), name)
    flat, flat_back = (flax.traverse_util.flatten_dict(t) for t in (params, back))
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))
    jmask = flax.traverse_util.flatten_dict(jbase._decay_mask(params))
    tmask = tbase._decay_mask(dict(model.named_parameters()))
    assert len(jmask) == len(tmask)
    for path, decayed in jmask.items():
        key, _ = weights._torch_leaf(name, path)
        assert tmask[key] == decayed, (path, key)


def test_registry_args_and_lazy_specs_equal_jax():
    names = lambda p: {a.dest: a.default for a in p._actions}       # noqa: E731
    for name in FAMILY:
        jm, m = jregistry.get_model(name), registry.get_model(name)
        assert names(jm.parse_model_args(argparse.ArgumentParser())) == \
            names(m.parse_model_args(argparse.ArgumentParser())), name
        assert jm.extra_log_args == m.extra_log_args, name
        assert (jm.reader, jm.runner, jm.batcher) == (m.reader, m.runner, m.batcher), name
        # the port's ComiRec alone has a catalog protocol the JAX package's
        # lacks: the multi-interest one (its K interests, scored by their max)
        assert m.multi_interest == (name == "ComiRec"), name
        assert jm.supports_catalog == (m.supports_catalog and not m.multi_interest), name
        assert getattr(jm, "candidate_aligned_keys", ()) == getattr(m, "candidate_aligned_keys", ())


@pytest.mark.parametrize("case", ["TiSASRec", "ComiRec", "SLRCPlus", "ContraKDA", "ContraRec-GRU4Rec",
                                  "TiMiRec-finetune", "Chorus-2"])
def test_lazy_table_specs_equal_jax(synth, tmp_path, case):
    """The same tables, gathered by the same feed keys: a JAX spec
    (module path, leaf) names the state_dict key `weights` maps it to."""
    jmodel, params, model, *_ = _build(synth, tmp_path, case)
    name = CASES[case][0]
    jspecs = jmodel.lazy_table_specs()
    flat = flax.traverse_util.flatten_dict(params)
    want = {weights._torch_leaf(name, path)[0]: keys for path, keys in jspecs.items() if path in flat}
    own = dict(model.named_parameters())
    got = {k: v for k, v in model.lazy_table_specs().items() if k in own}
    assert got == want
    assert bool(got) == (case in ("TiSASRec", "ComiRec", "SLRCPlus", "ContraKDA"))


@pytest.mark.parametrize("n_layers", [2, 3])
def test_timirec_projection_stack_equals_flax_in_evaluation(synth, tmp_path, n_layers):
    CASES["TiMiRec-deep"] = ("TiMiRec", dict(stage="finetune", K=3, attn_size=5, n_layers=n_layers))
    try:
        jmodel, params, model, _, _, jdev, tdev = _build(synth, tmp_path, "TiMiRec-deep")
    finally:
        del CASES["TiMiRec-deep"]
    assert f"proj_{n_layers - 2}" in params
    want = jmodel.apply({"params": params}, jdev, training=False)["prediction"]
    with torch.no_grad():
        np.testing.assert_allclose(model(tdev)["prediction"].numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)


# ------------------------------------------------------ shared functions
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("temperature", [0.2, 1.0])
def test_infonce_value_and_gradient_equal_jax(with_mask, temperature):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(12, 2, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=12)
    mask = labels[:, None] == labels[None, :] if with_mask else None
    jf = lambda f: jlosses.infonce(f, temperature, None if mask is None else jnp.asarray(mask))  # noqa: E731
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_(True)
    got = tlosses.infonce(x, temperature, None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= ATOL
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0, atol=ATOL)
    # the views are concatenated view-major: a row-major reshape would pair
    # each view with its own row's other view only by accident
    flipped = feats[:, ::-1].copy()
    assert float(tlosses.infonce(torch.from_numpy(flipped), temperature,
                                 None if mask is None else torch.from_numpy(mask))) \
        == pytest.approx(float(want), abs=ATOL)


@pytest.mark.parametrize("include_repeat,query", [(True, 3), (False, 3), (True, None)])
def test_relational_intervals_equal_jax(synth, include_repeat, query):
    corpus, jcorpus = synth["KGReader"]
    table = corpus.member_table()
    rng = np.random.default_rng(1)
    B, H, C = 16, 7, 9
    # histories of related items: candidates drawn from the same catalog
    hist = rng.integers(0, corpus.n_items, size=(B, H))
    hist[:, -2:] = 0
    times = np.sort(rng.integers(10 ** 8, 2 * 10 ** 8, size=(B, H)), axis=1)
    now = times[:, -1] + rng.integers(0, 10 ** 6, size=B)
    items = np.concatenate([hist[:, :3], rng.integers(1, corpus.n_items, size=(B, C - 3))], axis=1)
    args = (corpus.n_relations, corpus.n_entities, 86400.0 * 10, include_repeat)
    # under jit, as the JAX package always runs it (its batchers' precompute
    # and the train step): XLA multiplies by the reciprocal of time_scalar
    want = np.asarray(jax.jit(lambda *a: jkg.relational_intervals(*a, *args, query_relations=query))(
        jnp.asarray(hist), jnp.asarray(times), jnp.asarray(now), jnp.asarray(items), jnp.asarray(table)))
    got = tkg.relational_intervals(
        torch.from_numpy(hist), torch.from_numpy(times), torch.from_numpy(now), torch.from_numpy(items),
        torch.from_numpy(table).long(), *args, query_relations=query).numpy()
    assert got.dtype == np.float32 and got.shape == (B, C, query or corpus.n_relations)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got == -1).any()
    if include_repeat:
        assert (got[:, :3, 0] >= 0).all() == bool((hist[:, :3] > 0).all())


# -------------------------------------------------------------- batchers
BATCHERS = {"tisas": "TiSASRec", "slrc": "SLRCPlus", "chorus": "Chorus", "contra": "ContraRec",
            "contra_kda": "ContraKDA"}


def _compare_batcher(corpus, jcorpus, bname, phase, test_all, tmp_path, n_rows=64):
    name = BATCHERS[bname]
    args = _model_args(name, tmp_path, test_all=test_all, num_neg=1,
                       dataset=getattr(corpus, "dataset", "SynthKG"), history_max=20 if
                       corpus.n_items > 1000 else BASE["history_max"])
    if name == "Chorus":
        args.category_col = "i_category" if corpus.n_items > 1000 else "i_category_c"
    jmodel = jregistry.get_model(name).from_args(args, jcorpus)
    model = registry.get_model(name).from_args(args, corpus)
    b, jb = get_batcher(bname)(corpus, model, phase, args), jget_batcher(bname)(jcorpus, jmodel, phase, args)
    assert b.arrays.keys() == jb.arrays.keys() and len(b) == len(jb)
    for k in b.arrays:
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
    idx = np.sort(np.random.default_rng(0).choice(len(b), min(n_rows, len(b)), replace=False))
    if phase == "train":
        return b, arrays, idx
    # the JAX feeds under jit, as its runner builds them
    jfeed_fn = jax.jit(jb.eval_feed)
    feeds = [(b.eval_feed(arrays, torch.from_numpy(idx)), jfeed_fn(jarrays, jnp.asarray(idx, jnp.int32)))]
    if test_all:
        cands = np.random.default_rng(1).integers(0, corpus.n_items, (len(idx), 37))
        feeds.append((b.eval_feed(arrays, torch.from_numpy(idx), cands=torch.from_numpy(cands)),
                      jfeed_fn(jarrays, jnp.asarray(idx, jnp.int32), jnp.asarray(cands, jnp.int32))))
    for feed, jfeed in feeds:
        for k, v in jfeed.items():
            if k == "batch_size":
                continue
            got, want = feed[k].numpy(), np.asarray(v)
            assert got.shape == want.shape, k
            if k == "history_delta_t":                          # see test_torch_kda.py
                np.testing.assert_array_max_ulp(got, want, maxulp=2)
            elif k == "user_min_intervals":
                # the JAX device array is int32 (no x64): 0xFFFFFFFF is -1
                # there, the port's int64 keeps it; TiSASRec casts to int32
                np.testing.assert_array_equal(got & 0xFFFFFFFF, want.astype(np.int64) & 0xFFFFFFFF)
            else:
                np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
    return b, arrays, idx


@pytest.mark.parametrize("phase,test_all", [("train", 0), ("dev", 0), ("test", 1)])
@pytest.mark.parametrize("bname", list(BATCHERS))
def test_batcher_arrays_and_feeds_equal_jax_synthetic(synth, tmp_path, bname, phase, test_all):
    corpus, jcorpus = synth[registry.get_model(BATCHERS[bname]).reader]
    b, arrays, idx = _compare_batcher(corpus, jcorpus, bname, phase, test_all, tmp_path)
    if phase == "train":
        feed = b.train_feed({**arrays, **b.epoch_arrays(arrays, torch.Generator().manual_seed(0))},
                            torch.from_numpy(idx), torch.Generator().manual_seed(1))
        assert feed["item_id"].shape == (len(idx), 2)
        if bname in ("slrc", "chorus"):
            # the target's column precomputed, the negatives' per step: the
            # same intervals as computing every column in the step
            whole = b._interval_fn(feed["history_items"], feed["history_times"],
                                   arrays["time"][torch.from_numpy(idx)], feed["item_id"],
                                   arrays["_triplet_keys"])
            np.testing.assert_array_equal(feed["relational_interval"].numpy(), whole.numpy())
        if bname in ("contra", "contra_kda"):
            assert feed["history_items_a"].shape == feed["history_items"].shape


@pytest.mark.parametrize("phase,test_all", [("train", 0), ("dev", 0), ("test", 0), ("test", 1)])
@pytest.mark.parametrize("bname", ["tisas", "slrc", "chorus", "contra"])
def test_batcher_arrays_and_feeds_equal_jax_grocery(grocery, tmp_path, bname, phase, test_all):
    corpus, jcorpus = grocery
    corpus.dataset = GROCERY
    b, arrays, _ = _compare_batcher(corpus, jcorpus, bname, phase, test_all, tmp_path)
    if bname == "tisas":
        mins = b.arrays["user_min_intervals"]
        assert (mins > 0).all() and (mins == 0xFFFFFFFF).any() and (mins < 0xFFFFFFFF).mean() > 0.9
    if bname in ("slrc", "chorus") and phase != "train" and not test_all:
        ri = b.arrays["relational_interval"]
        assert ri.shape == (len(b), 100, 3) and (ri >= 0).mean() > 0.001
        if bname == "chorus":                                   # no repeat relation
            assert (ri[..., 0] == -1).all()


def test_chorus_stage1_batcher_feeds_reversed_triplets(synth, tmp_path):
    corpus, _ = synth["KGReader"]
    model = registry.get_model("Chorus").from_args(_model_args("Chorus", tmp_path, stage=1), corpus)
    b = get_batcher("chorus")(corpus, model, "train", _model_args("Chorus", tmp_path, stage=1))
    assert b.kg_train and len(b) == len(corpus.relation_df)
    arrays = b.device_arrays("cpu")
    idx = torch.arange(40)
    feed = b.train_feed(arrays, idx, torch.Generator().manual_seed(0))
    assert feed["head_id"].shape == feed["tail_id"].shape == feed["relation_id"].shape == (40, 4)
    # reversed: the feed's head column is the triplet's tail
    assert torch.equal(feed["head_id"][:, 0], arrays["kg_tail"][idx])
    assert torch.equal(feed["tail_id"][:, 0], arrays["kg_head"][idx])


# ------------------------------------------------------ augmentation
def _check_view(orig, view, length, k, mask_token):
    """One row of a view: the mask op (exactly k valid positions masked) or
    the reorder op (a permutation of a contiguous span of k positions);
    the pad positions untouched either way."""
    assert (view[length:] == orig[length:]).all()
    if k == 0:                                       # either op is the identity
        assert (view == orig).all()
        return "none"
    masked = view == mask_token
    if masked[:length].any():
        changed = view != orig
        assert masked[:length].sum() == k and (~changed | masked).all()
        return "mask"
    diff = np.nonzero(view[:length] != orig[:length])[0]
    if len(diff):
        assert diff.max() - diff.min() + 1 <= k
    # the whole prefix is a permutation, and no item moves out of a k-span
    assert sorted(view[:length]) == sorted(orig[:length])
    return "reorder"


@pytest.mark.parametrize("mask_token", [0, 999])
def test_beta_augment_invariants(mask_token):
    rng = np.random.default_rng(0)
    B, H = 4000, 12
    lengths = rng.integers(1, H + 1, size=B)
    hist = np.where(np.arange(H)[None, :] < lengths[:, None], rng.integers(1, 500, size=(B, H)), 0)
    gen = torch.Generator().manual_seed(7)
    state = torch.random.get_rng_state()
    view = beta_augment(gen, torch.from_numpy(hist), torch.from_numpy(lengths), 3.0, 3.0,
                        mask_token).numpy()
    assert torch.equal(torch.random.get_rng_state(), state), "no draw from the global generator"
    # the ratios are the generator's first draws
    ratio = beta_sample(torch.Generator().manual_seed(7), 3.0, 3.0, B).numpy()
    ks = np.floor(lengths * ratio).astype(int)
    ops = [_check_view(hist[r], view[r], lengths[r], ks[r], mask_token) for r in range(B)]
    share = ops.count("mask") / (B - ops.count("none"))
    assert 0.45 < share < 0.55 and ops.count("none") < B // 4
    # the same generator seed gives the same view, another seed another
    again = beta_augment(torch.Generator().manual_seed(7), torch.from_numpy(hist),
                         torch.from_numpy(lengths), 3.0, 3.0, mask_token).numpy()
    other = beta_augment(torch.Generator().manual_seed(8), torch.from_numpy(hist),
                         torch.from_numpy(lengths), 3.0, 3.0, mask_token).numpy()
    assert (again == view).all() and (other != view).any()
    # the JAX function's views keep the same invariants (for a mask count
    # that is floor(len x some ratio in [0, 1]))
    jview = np.asarray(jax_beta_augment(jax.random.key(0), jnp.asarray(hist[:500]),
                                        jnp.asarray(lengths[:500]), 3.0, 3.0, mask_token))
    for r in range(500):
        n_masked = int((jview[r, :lengths[r]] == mask_token).sum())
        _check_view(hist[r], jview[r], lengths[r], n_masked if n_masked else lengths[r], mask_token)


@pytest.mark.parametrize("a,b", [(3.0, 3.0), (2.0, 5.0)])
def test_beta_draws_pass_ks_against_scipy(a, b):
    x = beta_sample(torch.Generator().manual_seed(0), a, b, 20000).numpy()
    assert x.dtype == np.float32 and ((x > 0) & (x < 1)).all()
    assert scipy.stats.kstest(x, scipy.stats.beta(a, b).cdf).pvalue > 0.01


def test_contra_batchers_draw_views_from_the_step_generator(synth, tmp_path):
    for bname, reader, token in (("contra", "SeqReader", None), ("contra_kda", "KDAReader", 0)):
        corpus, _ = synth[reader]
        args = _model_args(BATCHERS[bname], tmp_path)
        model = registry.get_model(BATCHERS[bname]).from_args(args, corpus)
        b = get_batcher(bname)(corpus, model, "train", args)
        arrays = b.device_arrays("cpu")
        arrays = {**arrays, **b.epoch_arrays(arrays, torch.Generator().manual_seed(0))}
        state = torch.random.get_rng_state()
        f1 = b.train_feed(arrays, torch.arange(64), torch.Generator().manual_seed(3))
        f2 = b.train_feed(arrays, torch.arange(64), torch.Generator().manual_seed(3))
        assert torch.equal(torch.random.get_rng_state(), state)
        assert torch.equal(f1["history_items_a"], f2["history_items_a"])
        assert not torch.equal(f1["history_items_a"], f1["history_items_b"])
        token = corpus.n_items if token is None else token
        assert ((f1["history_items_a"] == token) & (f1["history_items"] != token)).any()


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name,lr,l2", [("Adam", 1e-3, 1e-6), ("Adam", 1e-2, 0.0), ("SGD", 1e-1, 1e-3)])
def test_lr_scaled_dense_update_equals_optax_chain(name, lr, l2):
    """Per-group lr scales (Chorus stage 2) against the JAX chain's last
    transform, five steps: 1e-6, the tolerance of the existing Adam test."""
    rng = np.random.default_rng(3)
    shapes = {"i_embeddings": (30, 8), "r_embeddings": (3, 8), "user_bias": (20, 1)}
    scales = {"i_embeddings": 0.1, "r_embeddings": 0.1, "user_bias": 1.0}
    flat = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.05 for k, s in shapes.items()}
             for _ in range(5)]
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    tx = jbase.build_optimizer(name, lr, l2, lr_scales=scales)
    jstate = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    opt = tbase.build_optimizer(name, lr, l2, lr_scales=scales)
    state = opt.init(params)
    plain = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    popt = tbase.build_optimizer(name, lr, l2)
    pstate = popt.init(plain)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(params, {k: torch.from_numpy(v) for k, v in g.items()}, state)
        popt.update(plain, {k: torch.from_numpy(v) for k, v in g.items()}, pstate)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6, err_msg=k)
    # the scaled tables moved a tenth as far as the unscaled run's
    for k in ("i_embeddings", "r_embeddings"):
        moved, full = params[k] - torch.from_numpy(flat[k]), plain[k] - torch.from_numpy(flat[k])
        assert float((moved - 0.1 * full).abs().max()) < 1e-6
    assert torch.allclose(params["user_bias"], plain["user_bias"], rtol=0, atol=1e-7)


# -------------------------------------------------------------------- CLI
@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    tlayers.set_table_dtype(None)
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


MODEL_FLAGS = {
    "TiSASRec": ["--num_layers", "1", "--num_heads", "2", "--time_max", "64"],
    "ComiRec": ["--attn_size", "8", "--K", "2"],
    "SLRCPlus": ["--time_scalar", str(86400 * 10)],
    "ContraRec": ["--encoder", "BERT4Rec", "--batch_size", "128"],
    "ContraKDA": ["--include_attr", "1", "--num_heads", "2", "--ccc_temp", "0.2"],
}


def _cli(root, tmp_path, name, tag, *flags):
    log = tmp_path / f"{tag}.log"
    state = port_main.build_parser_and_run([
        "--model_name", name, "--emb_size", "16", "--history_max", "8", "--lr", "1e-2",
        "--batch_size", "64", "--dataset", "SynthKG", "--path", str(root), "--gpu", "",
        "--random_seed", "7", "--log_file", str(log), "--save_final_results", "0", *flags])
    return state, log.read_text()


def _metrics(text, prefix):
    line = re.search(rf"^{prefix}: \((.*)\)$", text, re.M).group(1)
    return {k: float(v) for k, v in (kv.split(":") for kv in line.split(","))}


@pytest.mark.parametrize("lane", ["dense", "test_all", "lazy"])
@pytest.mark.parametrize("name", list(MODEL_FLAGS))
def test_cli_learns_in_every_lane(synth_root, tmp_path, name, lane):
    """Each single-stage model through the CLI on the CPU: finite falling
    losses, a lift of test HR@5 over the untrained model in the dense lane;
    `--test_all 1` ranks over the catalog (TiSASRec by its catalog
    protocol, ComiRec by the multi-interest one, the others by their
    forward); `--lazy_emb_adam 1` commits
    the lazy tables of the four models that declare them."""
    extra = {"dense": ["--epoch", "5"], "test_all": ["--epoch", "1", "--test_all", "1"],
             "lazy": ["--epoch", "2", "--lazy_emb_adam", "1", "--debug_nan_placeholder", "1"]}[lane]
    _, text = _cli(synth_root, tmp_path, name, lane, *MODEL_FLAGS[name], *extra,
                   "--model_path", str(tmp_path / "m.bin"))
    losses_seen = [float(x) for x in re.findall(r"^Epoch \d+\s+loss=(\S+) ", text, re.M)]
    assert losses_seen and np.isfinite(losses_seen).all()
    before, after = _metrics(text, "Test Before Training"), _metrics(text, "Test After Training")
    if lane == "dense":
        assert losses_seen[-1] < losses_seen[0]
        assert after["HR@5"] > before["HR@5"] and after["HR@5"] > 0.35, (before, after)
    if lane == "test_all":
        assert 0.0 <= after["HR@5"] <= 1.0
    if lane == "lazy":
        assert ("declares no lazy tables" in text) == (name == "ContraRec")


def test_contrarec_encoders_learn_through_the_cli(synth_root, tmp_path):
    for enc in ("GRU4Rec", "Caser"):
        _, text = _cli(synth_root, tmp_path, "ContraRec", enc, "--encoder", enc, "--epoch", "4",
                       "--model_path", str(tmp_path / f"{enc}.bin"))
        assert _metrics(text, "Test After Training")["HR@5"] > _metrics(text, "Test Before Training")["HR@5"]


def test_slrc_dense_feed_bytes_count_the_intervals(synth, tmp_path):
    """The tiled rule's dense-feed bytes count the [B, C, R] float
    intervals (and Chorus's category ids) per candidate."""
    corpus, _ = synth["KGReader"]
    runner = tbase.BaseRunner(_runner_args())
    for name, extra in (("SLRCPlus", 0), ("Chorus", 8)):
        args = _model_args(name, tmp_path, test_all=1)
        model = registry.get_model(name).from_args(args, corpus)
        b = get_batcher(registry.get_model(name).batcher)(corpus, model, "test", args)
        R = model.relation_num
        assert runner._dense_feed_bytes(b, b.device_arrays("cpu")) == \
            min(runner.eval_batch_size, len(b)) * corpus.n_items * (8 + 4 * R + extra)


def _runner_args(**kw):
    args = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args.__dict__.update(gpu="", random_seed=0, **kw)
    return args


CHORUS = ["--margin", "1", "--time_scalar", str(86400 * 10), "--category_col", "i_category_c"]


def test_chorus_two_stages_through_the_cli(synth_root, tmp_path, caplog):
    """Stage 2 raises without the stage-1 file; stage 1 saves every epoch
    to the well-known path beside --model_path; stage 2 starts from that
    file (with --train 0 its weights ARE the file's), trains the KG
    tables at --lr_scale, and under --lazy_emb_adam 1 warns and takes the
    dense optimizer."""
    model_path = str(tmp_path / "Chorus" / "x.bin")
    with pytest.raises(ValueError, match="stage 1"):
        _cli(synth_root, tmp_path, "Chorus", "no_stage1", *CHORUS, "--stage", "2", "--epoch", "1",
             "--model_path", model_path)
    _, text = _cli(synth_root, tmp_path, "Chorus", "stage1", *CHORUS, "--stage", "1", "--epoch", "3",
                   "--early_stop", "0", "--lr", "5e-3", "--model_path", model_path)
    pretrain = tmp_path / "Chorus" / "KG__SynthKG__emb_size=16__margin=1.0.bin"
    assert pretrain.exists() and not (tmp_path / "Chorus" / "x.bin").exists()
    assert len(re.findall(r"^Epoch \d+ .* \*$", text, re.M)) == 3     # saved every epoch
    state, text = _cli(synth_root, tmp_path, "Chorus", "loaded", *CHORUS, "--stage", "2",
                       "--train", "0", "--model_path", model_path)
    saved = weights.read_checkpoint(str(pretrain), state.model)
    assert "Load KG model from " + str(pretrain) in text
    got = state.model.state_dict()
    assert got.keys() == saved.keys() and all(torch.equal(got[k], saved[k]) for k in got)
    assert state.opt_state.slots["mu"] and state.model.lr_scales()["i_embeddings"] == 0.1
    state, text = _cli(synth_root, tmp_path, "Chorus", "stage2", *CHORUS, "--stage", "2",
                       "--epoch", "4", "--lazy_emb_adam", "1", "--model_path", model_path)
    assert "--lazy_emb_adam needs plain Adam without lr scales; falling back to the dense optimizer" \
        in text
    assert isinstance(state.opt_state, tbase.DenseOptState)
    assert _metrics(text, "Test After Training")["HR@5"] > _metrics(text, "Test Before Training")["HR@5"]


TIMIREC = ["--K", "2", "--attn_size", "8", "--add_pos", "1", "--add_trm", "1", "--lr", "5e-3"]


def test_timirec_two_stages_through_the_cli(synth_root, tmp_path):
    """Finetune without the extractor file trains from scratch (and says
    so); pretrain saves the extractor beside --model_path; finetune merges
    it by parameter name (with --train 0 the extractor's weights ARE the
    file's) and learns."""
    model_path = str(tmp_path / "TiMiRec" / "x.bin")
    _, text = _cli(synth_root, tmp_path, "TiMiRec", "scratch", *TIMIREC, "--stage", "finetune",
                   "--epoch", "1", "--model_path", model_path)
    assert "Train from scratch!" in text
    _, text = _cli(synth_root, tmp_path, "TiMiRec", "pretrain", *TIMIREC, "--stage", "pretrain",
                   "--epoch", "4", "--model_path", model_path)
    extractor = tmp_path / "TiMiRec" / "Extractor__SynthKG__7__emb_size=16__K=2__add_pos=1__add_trm=1.bin"
    assert extractor.exists()
    state, text = _cli(synth_root, tmp_path, "TiMiRec", "loaded", *TIMIREC, "--stage", "finetune",
                       "--train", "0", "--model_path", model_path)
    saved = weights.read_checkpoint(str(extractor), state.model)
    assert "Load extractor from " + str(extractor) in text and "Train from scratch!" not in text
    got = state.model.state_dict()
    assert saved.keys() < got.keys() and all(torch.equal(got[k], saved[k]) for k in saved)
    assert any(k.startswith("interest_predictor.") for k in got)
    _, text = _cli(synth_root, tmp_path, "TiMiRec", "finetune", *TIMIREC, "--stage", "finetune",
                   "--epoch", "4", "--lazy_emb_adam", "1", "--model_path", model_path)
    assert "declares no lazy tables" in text
    after = _metrics(text, "Test After Training")
    assert after["HR@5"] > _metrics(text, "Test Before Training")["HR@5"] and after["HR@5"] > 0.35
    with pytest.raises(ValueError, match="Invalid stage"):
        _cli(synth_root, tmp_path, "TiMiRec", "bad", "--stage", "distill", "--model_path", model_path)
