"""KDA's slice of the port against the JAX package on the same inputs:
KDAReader (triplets, entities, item values, shared attributes, the member
table, the interval lists and freq_x) on a synthetic KG corpus and on the
committed Grocery corpus; KDABatcher's arrays and feeds and its KG block;
the KDA model's prediction, KG prediction, loss and gradients with the
weights carried across, for every pooling with and without relation
values; the candidate-tiled full-catalog evaluation (ranks and top-k)
against the dense one and against the JAX runner; the routing rule of the
tiled evaluation; and the CLI in the dense and packed lanes.

Small sizes: D = 16, 2 heads, history 5, 1-2 layers. Weights are redrawn
from numpy at O(0.3) so that activations are O(1). Tolerance 1e-5
absolute for forward values, losses and gradients (f32 products and sums
in two libraries), 2 ulp for the log-normalized time deltas (XLA's CPU
division and log2 round differently from PyTorch's); readers, the other
feeds, ranks and routes are compared exactly.
"""
import argparse
import json
import os
import pickle
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.data.readers import KDAReader as JaxKDAReader
from rechorus_tpu.data.synthetic import make_kg_dataset as jax_make_kg_dataset
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.ops import kg as jkg
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import KDABatcher
from rechorus_tpu_torch.data.readers import KDAReader
from rechorus_tpu_torch.ops import cuda_kernels
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.ops.losses import masked_softmax
from rechorus_tpu_torch.runners import base as tbase

ATOL = 1e-5
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GROCERY = "Grocery_and_Gourmet_Food"
MODEL = dict(emb_size=16, num_layers=1, num_heads=2, history_max=5, gamma=-1.0, attention_size=6,
             pooling="average", include_val=1, neg_head_p=0.5, num_neg=1, dropout=0.0,
             test_all=0, host_shard_input=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reader_args(root, dataset, **kw):
    """KDAReader's flags; Grocery at bench.py's --n_dft default."""
    return argparse.Namespace(path=str(root), dataset=dataset, sep="\t", include_attr=1,
                              t_scalar=60, n_dft=64 if dataset == GROCERY else 32, freq_rand=0,
                              regenerate=1, **kw)


def _synthetic(root, name, **kw):
    """One corpus, written by the port's generator; both packages' readers
    read it (each writes its own caches beside it)."""
    synthetic.make_kg_dataset(str(root / name), **kw)
    return root


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return _synthetic(tmp_path_factory.mktemp("kda_synth"), "SynthKG",
                      n_users=80, n_items=120, n_per_user=10)


@pytest.fixture(scope="module")
def grocery_root(tmp_path_factory):
    """Grocery's committed files, linked: the interval caches land here."""
    root = tmp_path_factory.mktemp("kda_grocery")
    os.makedirs(root / GROCERY)
    for f in ("train.csv", "dev.csv", "test.csv", "item_meta.csv"):
        os.symlink(os.path.join(DATA, GROCERY, f), root / GROCERY / f)
    return root


@pytest.mark.parametrize("kw", [dict(n_users=80, n_items=120, n_per_user=10),
                                dict(n_users=30, n_items=10, n_per_user=4, n_groups=4, seed=5)],
                         ids=["groups_of_30", "groups_of_2_or_3"])
def test_port_kg_generator_keeps_the_jax_contract(tmp_path, kw):
    """The port's generator writes the JAX generator's interactions byte for
    byte, and relation lists of the same contract: per item, min(3 or 2,
    group size - 1) distinct items of its own group, sorted, never itself."""
    synthetic.make_kg_dataset(str(tmp_path / "port"), **kw)
    jax_make_kg_dataset(str(tmp_path / "jax"), **kw)
    for f in ("train.csv", "dev.csv", "test.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    mine = pd.read_csv(tmp_path / "port" / "item_meta.csv", sep="\t")
    theirs = pd.read_csv(tmp_path / "jax" / "item_meta.csv", sep="\t")
    assert list(mine.columns) == list(theirs.columns)
    pd.testing.assert_series_equal(mine["item_id"], theirs["item_id"])
    pd.testing.assert_series_equal(mine["i_category_c"], theirs["i_category_c"])
    n_groups = kw.get("n_groups", 4)
    for col, k in (("r_complement", 3), ("r_substitute", 2)):
        for it, text, their_text in zip(mine["item_id"], mine[col], theirs[col]):
            rel = json.loads(text)
            group = [j for j in mine["item_id"] if j % n_groups == it % n_groups and j != it]
            assert len(rel) == len(json.loads(their_text)) == min(k, len(group)), (col, it)
            assert rel == sorted(set(rel)) and set(rel) <= set(group), (col, it, rel)


@pytest.fixture(scope="module", params=["synthetic", "grocery"])
def readers(request, synth_root, grocery_root):
    if request.param == "synthetic":
        root, name = synth_root, "SynthKG"
    else:
        root, name = grocery_root, GROCERY
    return request.param, root / name, KDAReader(_reader_args(root, name)), \
        JaxKDAReader(_reader_args(root, name))


def test_kda_reader_equals_jax(readers):
    name, folder, corpus, jcorpus = readers
    pd.testing.assert_frame_equal(corpus.relation_df, jcorpus.relation_df)
    assert (corpus.n_relations, corpus.n_entities, corpus.n_dft) == \
        (jcorpus.n_relations, jcorpus.n_entities, jcorpus.n_dft)
    np.testing.assert_array_equal(corpus.item_value_matrix(), jcorpus.item_value_matrix())
    for a, b in zip(corpus.share_attr_matrix(), jcorpus.share_attr_matrix()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(corpus.member_table(), jcorpus.member_table())
    np.testing.assert_allclose(corpus.freq_x, jcorpus.freq_x, rtol=0, atol=1e-6)
    # the interval lists themselves, from each package's own cache file
    with open(folder / "interval.torch.pkl", "rb") as f:
        mine = pickle.load(f)
    with open(folder / "interval.pkl", "rb") as f:
        theirs = pickle.load(f)
    assert mine.keys() == theirs.keys() == {"virtual", *corpus.relations}
    for key in mine:
        np.testing.assert_array_equal(np.asarray(mine[key], np.int64),
                                      np.asarray(theirs[key], np.int64), err_msg=key)
        assert len(mine[key]) > 0, key
    if name == "grocery":
        assert (corpus.n_relations, corpus.n_entities, len(corpus.relation_df)) == (4, 8771, 373_741)
        assert corpus.freq_x.shape == (4, 33)


def test_kda_reader_reads_its_own_cache(readers):
    """A second reader loads interval.torch.pkl (never the JAX package's
    interval.pkl) and gets the same freq_x."""
    name, folder, corpus, _ = readers
    again = KDAReader(_reader_args(folder.parent, folder.name))
    np.testing.assert_array_equal(again.freq_x, corpus.freq_x)
    args = _reader_args(folder.parent, folder.name)
    args.regenerate = 0
    with open(folder / "interval.torch.pkl", "rb") as f:
        cached = pickle.load(f)
    cached["virtual"] = np.asarray([60 * 2 ** 7] * 3)           # a visible change
    with open(folder / "interval.torch.pkl", "wb") as f:
        pickle.dump(cached, f)
    try:
        assert not np.array_equal(KDAReader(args).freq_x[0], corpus.freq_x[0])
    finally:
        KDAReader(_reader_args(folder.parent, folder.name))      # rewrite the true cache


def _model_args(**kw):
    return argparse.Namespace(**{**MODEL, **kw})


def _torch_feed(jfeed):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64 if np.asarray(v).dtype.kind in "iu"
                                                      else np.float32))
            for k, v in jfeed.items() if hasattr(v, "shape")}


@pytest.mark.parametrize("phase,test_all", [("dev", 0), ("test", 0), ("test", 1), ("train", 0)])
def test_kda_batcher_arrays_and_feeds_equal_jax(readers, phase, test_all):
    _, _, corpus, jcorpus = readers
    args = _model_args(test_all=test_all)
    jmodel = jregistry.get_model("KDA").from_args(args, jcorpus)
    model = registry.get_model("KDA").from_args(args, corpus)
    b, jb = KDABatcher(corpus, model, phase, args), jget_batcher("kda")(jcorpus, jmodel, phase, args)
    assert b.arrays.keys() == jb.arrays.keys() and len(b) == len(jb)
    for k in b.arrays:
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    idx = np.sort(np.random.default_rng(0).choice(len(b), min(64, len(b)), replace=False))
    arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
    if phase == "train":
        return                                                  # draws differ by design
    feeds = [(b.eval_feed(arrays, torch.from_numpy(idx)),
              jb.eval_feed(jarrays, jnp.asarray(idx, jnp.int32)))]
    if test_all:                                                # a block of candidates
        cands = np.random.default_rng(1).integers(0, corpus.n_items, (len(idx), 37))
        feeds.append((b.eval_feed(arrays, torch.from_numpy(idx), cands=torch.from_numpy(cands)),
                      jb.eval_feed(jarrays, jnp.asarray(idx, jnp.int32),
                                   cands=jnp.asarray(cands, jnp.int32))))
    for feed, jfeed in feeds:
        assert {k for k in jfeed if hasattr(jfeed[k], "shape")} <= set(feed)
        for k, v in jfeed.items():
            if not hasattr(v, "shape"):
                continue
            got, want = feed[k].numpy(), np.asarray(v)
            assert got.shape == want.shape, k
            if k == "history_delta_t":
                # XLA's CPU division and log2 round differently from
                # PyTorch's in the last bit for 10-30% of inputs
                np.testing.assert_array_max_ulp(got, want, maxulp=2)
                continue
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
        assert feed["item_val"].shape == feed["item_id"].shape + (corpus.n_relations,)
        assert feed["history_delta_t"].dtype == torch.float32


def test_kda_kg_block_shapes_ranges_and_rejection(readers):
    _, _, corpus, jcorpus = readers
    args = _model_args(num_neg=3)
    model = registry.get_model("KDA").from_args(args, corpus)
    b = KDABatcher(corpus, model, "train", args)
    arrays = b.device_arrays("cpu")
    extra = b.epoch_arrays(arrays, torch.Generator().manual_seed(0))
    M, n_items = len(b), corpus.n_items
    assert extra["_ep_kg_head_id"].shape == extra["_ep_kg_tail_id"].shape == (M, 4)
    assert extra["_ep_kg_relation_id"].shape == extra["_ep_kg_value_id"].shape == (M,)
    feed = b.train_feed({**arrays, **extra}, torch.arange(7, 30), torch.Generator().manual_seed(1))
    assert torch.equal(feed["head_id"], extra["_ep_kg_head_id"][7:30])
    h, t = extra["_ep_kg_head_id"].numpy(), extra["_ep_kg_tail_id"].numpy()
    r, val = extra["_ep_kg_relation_id"].numpy(), extra["_ep_kg_value_id"].numpy()
    assert ((h >= 1) & (h < n_items)).all() and ((t >= 1) & (t < n_items)).all()
    assert ((r >= 1) & (r < corpus.n_relations)).all()
    is_attr = val > 0
    assert ((val[is_attr] >= n_items) & (val[is_attr] < corpus.n_entities)).all()
    assert is_attr.any() and (~is_attr).any()
    table = jnp.asarray(jcorpus.member_table())
    n_rel, n_ent = corpus.n_relations, corpus.n_entities
    # the positive: a stored triplet, or an item sharing the attribute value
    probe_t = np.where(is_attr, val, t[:, 0])
    assert np.asarray(jkg.is_member(table, jnp.asarray(h[:, 0]), jnp.asarray(r),
                                    jnp.asarray(probe_t), n_rel, n_ent)).all()
    # each corruption replaces the head or the tail, never both
    head_side, tail_side = h[:, 1:] != h[:, :1], t[:, 1:] != t[:, :1]
    assert not (head_side & tail_side).any()
    assert 0.3 < head_side.mean() / max(1e-9, (head_side | tail_side).mean()) < 0.7
    # no accepted corruption is a triplet (up to the sampler's last-round
    # fallback, whose share is (density)^9 -- none at these densities)
    bad_head = np.asarray(jkg.is_member(table, jnp.asarray(h[:, 1:]), jnp.asarray(r[:, None]),
                                        jnp.asarray(probe_t[:, None]), n_rel, n_ent))
    bad_tail = np.where(is_attr[:, None],
                        np.asarray(jkg.is_member(table, jnp.asarray(t[:, 1:]), jnp.asarray(r[:, None]),
                                                 jnp.asarray(val[:, None]), n_rel, n_ent)),
                        np.asarray(jkg.is_member(table, jnp.asarray(h[:, :1]), jnp.asarray(r[:, None]),
                                                 jnp.asarray(t[:, 1:]), n_rel, n_ent)))
    assert not (head_side & bad_head).any() and not (tail_side & bad_tail).any()


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def synth_pair(synth_root):
    return KDAReader(_reader_args(synth_root, "SynthKG")), JaxKDAReader(_reader_args(synth_root, "SynthKG"))


def _redraw(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.3), params)


def _build(synth_pair, **kw):
    """(flax model, flax params, torch model with the same weights, jax
    train feed, torch train feed): 48 train rows with their KG block."""
    corpus, jcorpus = synth_pair
    args = _model_args(**kw)
    jmodel = jregistry.get_model("KDA").from_args(args, jcorpus)
    jb = jget_batcher("kda")(jcorpus, jmodel, "train", args)
    jfeed = jb.train_feed(jb.device_arrays(), jnp.arange(48, dtype=jnp.int32), jax.random.key(3))
    params = jmodel.init(jax.random.key(0), jfeed, training=False)["params"]
    params = jax.device_get(_redraw(params, 1))
    model = registry.get_model("KDA").from_args(args, corpus)
    model.load_state_dict(weights.from_flax_params(params, "KDA"), strict=True)
    return jmodel, params, model, jfeed, _torch_feed(jfeed)


@pytest.mark.parametrize("include_val", [0, 1])
@pytest.mark.parametrize("pooling", ["average", "max", "attention"])
def test_kda_forward_loss_and_gradients_equal_flax(synth_pair, pooling, include_val):
    jmodel, params, model, jfeed, tfeed = _build(synth_pair, pooling=pooling, include_val=include_val,
                                                 num_layers=2 if pooling == "attention" else 1)
    want = jmodel.apply({"params": params}, jfeed, training=False)
    got = model(tfeed)
    for key, shape in (("prediction", (48, 2)), ("kg_prediction", (48, 2))):
        g = got[key].detach().numpy()
        assert g.shape == shape and np.abs(g).max() > 0.1, key
        np.testing.assert_allclose(g, np.asarray(want[key]), rtol=0, atol=ATOL, err_msg=key)

    def jloss(p):
        return jmodel.loss(jmodel.apply({"params": p}, jfeed, training=False), jfeed)

    jl, jgrads = jax.value_and_grad(jloss)(params)
    loss = model.loss(model(tfeed), tfeed)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= ATOL
    want_g = weights.from_flax_params(jax.device_get(jgrads), "KDA")
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=0, atol=ATOL, err_msg=k)
    assert float(model.gamma) == pytest.approx(len(synth_pair[0].relation_df) / len(synth_pair[0].all_df))


@pytest.mark.parametrize("pooling", ["average", "attention"])
def test_kda_params_round_trip_and_l2_exempt_set(synth_pair, pooling):
    jmodel, params, model, _, _ = _build(synth_pair, pooling=pooling)
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    back = weights.to_flax_params(model.state_dict(), "KDA")
    flat, flat_back = (flax.traverse_util.flatten_dict(t) for t in (params, back))
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))
    jmask = flax.traverse_util.flatten_dict(jbase._decay_mask(params))
    tmask = tbase._decay_mask(dict(model.named_parameters()))
    assert len(jmask) == len(tmask)
    for path, decayed in jmask.items():
        key, _ = weights._torch_leaf("KDA", path)
        assert tmask[key] == decayed, (path, key)
    exempt = {k for k, v in tmask.items() if not v}
    assert "item_bias.weight" in exempt and all("bias" in k for k in exempt)
    with pytest.raises(KeyError, match="unmapped"):
        weights.from_flax_params({"gamma_table": np.zeros(3, np.float32)}, "KDA")


def test_kda_frequency_parameters_start_from_freq_x(synth_pair):
    corpus, _ = synth_pair
    model = registry.get_model("KDA").from_args(_model_args(), corpus)
    model.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(model.freq_real.detach().numpy(), np.real(corpus.freq_x).astype(np.float32))
    np.testing.assert_array_equal(model.freq_imag.detach().numpy(), np.imag(corpus.freq_x).astype(np.float32))
    assert model.freq_real.shape == (corpus.n_relations, corpus.n_dft // 2 + 1)
    assert float(model.relation_embeddings.detach().std()) == pytest.approx(0.01, rel=0.3)


def test_masked_softmax_equals_jax():
    from rechorus_tpu.ops import losses as jlosses

    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 7)).astype(np.float32) * 3
    mask = rng.random((6, 5, 7)) < 0.6
    mask[0, 0] = False                                          # an all-masked row
    for dim in (1, 2):
        want = np.asarray(jlosses.masked_softmax(jnp.asarray(x), jnp.asarray(mask), axis=dim))
        got = masked_softmax(torch.from_numpy(x), torch.from_numpy(mask), dim=dim).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[0, 0].any()


# ------------------------------------------------------------ tiled eval
def _runner_args(**kw):
    parser = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser())
    args = parser.parse_args(["--eval_batch_size", "16", "--lr", "1e-2"])
    args.__dict__.update(gpu="", random_seed=7, **{**MODEL, **kw})
    return args


def _jax_runner_args(**kw):
    args = jbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args(
        ["--eval_batch_size", "16", "--lr", "1e-2"])
    args.__dict__.update(random_seed=7, **{**MODEL, **kw})
    return args


@pytest.fixture(scope="module")
def big_pair(tmp_path_factory):
    """9,000 items, past the 8,192 above which the port used to refuse a
    forward evaluation, under the 4 x 8,192 of the tiled rule."""
    root = _synthetic(tmp_path_factory.mktemp("kda_big"), "BigKG", n_users=40, n_items=9000,
                      n_per_user=8)
    return KDAReader(_reader_args(root, "BigKG")), JaxKDAReader(_reader_args(root, "BigKG"))


@pytest.fixture(scope="module")
def tiled_setup(big_pair):
    """Port and JAX runners, models with the same weights and test
    batchers, --test_all 1."""
    corpus, jcorpus = big_pair
    jargs = _jax_runner_args(test_all=1)
    jmodel = jregistry.get_model("KDA").from_args(jargs, jcorpus)
    jrunner = jbase.BaseRunner(jargs)
    jb = {p: jget_batcher("kda")(jcorpus, jmodel, p, jargs) for p in ("train", "test")}
    jstate = jrunner.init_state(jmodel, jb["train"], 7)
    params = jax.device_get(_redraw(jstate.params, 2))
    jstate = jstate.replace(params=params)
    args = _runner_args(test_all=1)
    model = registry.get_model("KDA").from_args(args, corpus)
    runner = tbase.BaseRunner(args)
    state = runner.init_state(model, 7)
    model.load_state_dict(weights.from_flax_params(params, "KDA"), strict=True)
    tb = KDABatcher(corpus, model, "test", args)
    return dict(runner=runner, state=state, batcher=tb, arrays=tb.device_arrays("cpu"),
                jrunner=jrunner, jmodel=jmodel, jstate=jstate, jbatcher=jb["test"],
                jarrays=jb["test"].device_arrays())


def test_tiled_ranks_equal_dense_and_jax(tiled_setup, monkeypatch):
    s = tiled_setup
    runner, b = s["runner"], s["batcher"]
    want = s["jrunner"].predict_ranks(s["jstate"], s["jmodel"], s["jbatcher"], s["jarrays"], "test")
    assert not runner._use_tiled_forward(s["state"].model, b, s["arrays"])   # dense at 9,000
    dense = runner.predict_ranks(s["state"], b, s["arrays"], "test")
    calls = []
    count = cuda_kernels.ge_count
    monkeypatch.setattr(tbase, "ge_count", lambda p, t: calls.append(p.shape) or count(p, t))
    monkeypatch.setattr(runner, "eval_candidate_chunk", 251)
    assert runner._use_tiled_forward(s["state"].model, b, s["arrays"])       # 9,000 > 4 x 251
    tiled = runner.predict_ranks(s["state"], b, s["arrays"], "test")
    np.testing.assert_array_equal(dense, np.asarray(want))
    np.testing.assert_array_equal(tiled, dense)
    n_items = b.corpus.n_items                                 # ids 0..9000
    n_chunks, n_batches = -(-n_items // 251), -(-len(b) // 16)
    assert len(calls) == n_chunks * n_batches                  # B1 once per chunk
    assert calls[n_chunks - 1] == (16, n_items - 251 * (n_chunks - 1))   # the last one sliced
    assert ((tiled >= 1) & (tiled < n_items)).all() and len(set(tiled.tolist())) > len(tiled) // 2


@pytest.mark.parametrize("toward", [float("inf"), float("-inf")], ids=["t_up", "t_down"])
def test_tiled_ranks_hold_when_the_target_forward_is_an_ulp_apart(tiled_setup, monkeypatch, toward):
    """The target's score t comes from a one-candidate forward, which on the
    card may score the target an ulp apart from the forward of its chunk
    (another shape, another GEMM). Planted here by moving t one ulp: the
    tiled ranks still equal the dense ones, and none falls below 1 (with the
    corrections taken from the one-candidate forward, t one ulp up would
    drop the target from B1's count but still subtract it)."""
    s = tiled_setup
    runner, b = s["runner"], s["batcher"]
    dense = runner.predict_ranks(s["state"], b, s["arrays"], "test")
    forward, moved = tbase.BaseRunner._apply_eval, []

    def target_moved(model, feed):
        out = forward(model, feed)
        if feed["item_id"].shape[1] == 1:                      # the target's own forward
            moved.append(out["prediction"].shape)
            out = {**out, "prediction": torch.nextafter(out["prediction"], torch.tensor(toward))}
        return out

    monkeypatch.setattr(runner, "_apply_eval", target_moved)
    monkeypatch.setattr(runner, "eval_candidate_chunk", 251)
    tiled = runner.predict_ranks(s["state"], b, s["arrays"], "test")
    assert len(moved) == -(-len(b) // 16)                      # once per batch
    np.testing.assert_array_equal(tiled, dense)
    assert (tiled >= 1).all()


def test_tiled_topk_equals_dense_and_jax(tiled_setup, monkeypatch):
    s = tiled_setup
    runner, b = s["runner"], s["batcher"]
    want_i, want_v = s["jrunner"].predict_topk(s["jstate"], s["jmodel"], s["jbatcher"], s["jarrays"],
                                               "test", k=20)
    dense_i, dense_v = runner.predict_topk(s["state"], b, s["arrays"], "test", k=20)
    monkeypatch.setattr(runner, "eval_candidate_chunk", 251)
    tiled_i, tiled_v = runner.predict_topk(s["state"], b, s["arrays"], "test", k=20)
    np.testing.assert_array_equal(tiled_v, dense_v)
    np.testing.assert_allclose(dense_v, np.asarray(want_v), rtol=0, atol=ATOL)
    assert tiled_i.shape == dense_i.shape == (len(b), 20) and tiled_i.dtype == np.int32
    distinct = (np.abs(dense_v[:, :, None] - dense_v[:, None, :]) <= 1e-5).sum(-1) == 1
    assert distinct.mean() > 0.9
    assert (tiled_i[distinct] == dense_i[distinct]).all()
    assert (dense_i[distinct] == np.asarray(want_i)[distinct]).all()
    clicked = s["arrays"]["_clicked_all"][s["arrays"]["user_id"]].numpy()
    assert not (tiled_i[:, :, None] == clicked[:, None, :]).any() and (tiled_i > 0).all()


@pytest.mark.parametrize("chunk,max_bytes", [(16384, 2 << 30),   # one chunk covers the catalog
                                             (2000, 2 << 30),    # more than four chunks
                                             (8192, 2 << 30),    # 2..4 chunks, a light feed
                                             (8192, 1 << 20)])   # 2..4 chunks, past the bytes limit
def test_tiled_route_follows_the_jax_rule(tiled_setup, monkeypatch, chunk, max_bytes):
    """The three triggers of the JAX `_use_tiled_forward` at 9,000 items,
    the bytes limit lowered on both sides for the last case (the port's
    int64 ids count 9001 x 16 x 40 B = 5.8 MB, the JAX int32 ones 2.9 MB)."""
    s = tiled_setup
    for r in (s["runner"], s["jrunner"]):
        monkeypatch.setattr(r, "eval_candidate_chunk", chunk)
        monkeypatch.setattr(r, "MAX_DENSE_FEED_BYTES", max_bytes)
    model = s["state"].model
    got = s["runner"]._use_tiled_forward(model, s["batcher"], s["arrays"])
    assert got == s["jrunner"]._use_tiled_forward(s["jmodel"], s["jbatcher"])
    assert got == (chunk == 2000 or max_bytes < 2 << 30)
    assert s["runner"]._dense_feed_bytes(s["batcher"], s["arrays"]) == 9001 * 16 * 8 * (1 + 4)
    # the dense and tiled routes answer alike; the old flat refusal is gone
    ranks = s["runner"].predict_ranks(s["state"], s["batcher"], s["arrays"], "test")
    assert ranks.shape == (len(s["batcher"]),) and (ranks >= 1).all()


def test_check_under_test_all_runs_one_candidate_chunk(tiled_setup, monkeypatch, caplog):
    s = tiled_setup
    runner, model = s["runner"], s["state"].model
    monkeypatch.setattr(runner, "eval_candidate_chunk", 2000)
    widths, forward = [], type(model).forward

    def spy(self, feed, training=False, gen=None):
        widths.append(feed["item_id"].shape)
        return forward(self, feed, training=training, gen=gen)

    monkeypatch.setattr(type(model), "forward", spy)
    with caplog.at_level("INFO"):
        runner.check(s["state"], s["batcher"], s["arrays"])
    assert widths == [(16, 2000)]
    assert re.search(r"attn_0/attention +shape=16x2000x2x4x4 ", caplog.text)


# ------------------------------------------------------------------- CLI
@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    tlayers.set_table_dtype(None)
    import logging

    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


@pytest.mark.parametrize("lane", [[], ["--lazy_emb_adam", "1", "--debug_nan_placeholder", "1"]],
                         ids=["dense", "packed"])
def test_kda_cli_trains_reloads_and_exports(tmp_path, lane):
    root = _synthetic(tmp_path, "CliKG", n_users=120, n_items=80, n_per_user=10)

    def run(tag, *extra):
        log = tmp_path / f"{tag}.log"
        port_main.build_parser_and_run([
            "--model_name", "KDA", "--emb_size", "16", "--include_attr", "1", "--num_heads", "2",
            "--history_max", "5", "--lr", "1e-2", "--batch_size", "64", "--dataset", "CliKG",
            "--path", str(root), "--gpu", "", "--log_file", str(log), "--check_epoch", "2",
            "--model_path", str(tmp_path / "kda.bin"), *lane, *extra])
        return log.read_text()

    text = run("train", "--epoch", "4")
    losses = [float(x) for x in re.findall(r"^Epoch \d+\s+loss=([\d.]+)", text, re.M)]
    assert len(losses) == 4 and losses[-1] < losses[0]
    dev = [float(x) for x in re.findall(r"dev=\(HR@5:([\d.]+)", text)]
    assert max(dev) > 0.4                                       # chance is 0.25
    assert re.search(r"^attn_0/attention +shape=\S+x20x2x4x4 ", text, re.M)
    test_after = re.search(r"^Test After Training: (\(.*\))$", text, re.M).group(1)
    export = pd.read_csv(root / "CliKG" / "rec-KDA-test.csv", sep="\t")
    assert len(eval(export["rec_items"][0])) == 20
    text2 = run("reload", "--load", "1", "--train", "0", "--save_final_results", "0")
    assert re.search(r"^Test Before Training: (\(.*\))$", text2, re.M).group(1) == test_after
    assert (root / "CliKG" / "KDAReader.torch.pkl").exists()
    assert (root / "CliKG" / "interval.torch.pkl").exists()
    assert not (root / "CliKG" / "interval.pkl").exists()
