"""The impression task in the port against the JAX package: the listwise
losses (value and gradient, every variant, with pad rows, rows without
negatives and singleton rows), `evaluate_impression`, the generator's
files byte for byte, the three impression readers (requests, lists, dual
histories; a hand-made corpus exercises the id-0 filter and the dropped
requests), both batchers' arrays and feeds (the `--test_all` feed too),
`BiLSTM`, the four Impression models' forward with the weights carried
across (`weights.from_flax_params`), ImpressionRunner's metrics and the
prediction export in both branches on the same weights, the lazy lane's
step against the JAX runner's (BPRMFImpression: the B4 commit of both
tables; SASRecImpression: the history rows read without gradient), the
JAX package's error for LightGCNImpression's lazy lane, and a learning
test per model through the CLI.

Small sizes: D = 8 to 16, history 5, caps 3 / 5. Tolerance 1e-5 absolute
for forward values, losses and gradients; readers, batchers and the
generator are compared exactly.
"""
import argparse
import filecmp
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rechorus_tpu import main as jmain
from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import readers_all  # noqa: F401  (registers the JAX readers)
from rechorus_tpu.data import synthetic as jsynthetic
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.ops import layers as jlayers
from rechorus_tpu.ops import losses as jlosses
from rechorus_tpu.ops import metrics as jmetrics
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.ops import losses, metrics
from rechorus_tpu_torch.runners import base as tbase

ATOL = 1e-5
SYNTH = dict(n_users=60, n_items=50, n_impressions=6, noise=0.3)
BASE = dict(path="", dataset="SynthImp", sep="\t", impression_idkey="time", emb_size=8, history_max=5,
            num_neg=1, dropout=0.0, test_all=0, gpu="", random_seed=0, loss_n="BPR",
            train_max_pos_item=3, train_max_neg_item=5, test_max_pos_item=3, test_max_neg_item=5,
            num_layers=1, num_heads=2, hidden_size=8, n_layers=2, model_path="")
MODELS = ["BPRMFImpression", "LightGCNImpression", "SASRecImpression", "GRU4RecImpression"]
LOSSES = ["BPR", "BPRafter", "BPRbefore", "BPRsimple", "BPRhard", "BPRafterhard", "listnet",
          "softmaxCE", "attention_rank"]


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
def _reset_logging():
    yield
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("imp")
    synthetic.make_impression_dataset(str(root / "SynthImp"), **SYNTH)
    synthetic.make_impression_dataset(str(root / "SynthImpLearn"))
    _edge_corpus(str(root / "Edge"))
    return str(root)


def _edge_corpus(path):
    """Requests without positives, without negatives, with an id-0 row,
    duplicated items, and two users with equal times; an `impression_id`
    column that splits one user's equal times into two requests."""
    rows = []
    for u in range(1, 7):
        for r, t in enumerate([10, 20, 20, 30, 40]):
            imp = r + 100 * u
            labels = [1, 0, 0] if (u + r) % 4 else [0, 0]
            if (u * r) % 5 == 3 or (u, r) == (5, 0):
                labels = [1, 1]
            for j, lab in enumerate(labels):
                rows.append((u, (u * 7 + r * 3 + j) % 11 + (0 if (u, r, j) == (2, 1, 1) else 1), t, imp, lab))
            if (u, r) not in ((4, 0), (5, 0)):     # (4, 0) has no positive, (5, 0) no negative
                rows.append((u, (u + r) % 11 + 1, t, imp, 1 - (r % 2)))    # a duplicate-prone row
    df = pd.DataFrame(rows, columns=["user_id", "item_id", "time", "impression_id", "label"])
    os.makedirs(path, exist_ok=True)
    t = df["time"]
    df[t <= 20].to_csv(os.path.join(path, "train.csv"), sep="\t", index=False)
    df[t == 30].to_csv(os.path.join(path, "dev.csv"), sep="\t", index=False)
    df[t == 40].to_csv(os.path.join(path, "test.csv"), sep="\t", index=False)


def _args(root, **kw):
    """Every flag of the impression models and readers at BASE's values."""
    return argparse.Namespace(**{**BASE, "path": root, **kw})


def _pair(args, reader):
    return registry.get_reader(reader)(args), jregistry.get_reader(reader)(args)


# ------------------------------------------------------------------ losses
def _loss_inputs():
    """[B, P + N] scores and targets with P = 3: full rows, pad rows, rows
    without a valid negative, singleton rows (one valid entry) and a row
    with one positive and one negative."""
    rng = np.random.default_rng(0)
    P, N, B = 3, 5, 9
    pos_n = np.array([3, 1, 2, 1, 2, 3, 1, 1, 2])
    neg_n = np.array([5, 2, 0, 0, 4, 1, 1, 3, 0])
    target = np.full((B, P + N), -1.0, np.float32)
    for r in range(B):
        target[r, : pos_n[r]] = 1.0
        target[r, P: P + neg_n[r]] = 0.0
    pred = rng.normal(size=(B, P + N)).astype(np.float32) * 2
    pred[0, 1] = pred[0, 4]       # a tie between a positive and a negative
    return pred, target, P


@pytest.mark.parametrize("loss_n", LOSSES)
def test_impression_loss_value_and_gradient_equal_jax(loss_n):
    pred, target, P = _loss_inputs()
    jl, jg = jax.value_and_grad(lambda p: jlosses.impression_loss(p, jnp.asarray(target), P, loss_n))(
        jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = losses.impression_loss(x, torch.from_numpy(target), P, loss_n)
    got.backward()
    got = float(got.detach())
    assert np.isfinite(got) and abs(got - float(jl)) <= ATOL, (got, float(jl))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=0, atol=ATOL)
    assert np.abs(x.grad.numpy()).max() > 1e-3
    if loss_n == "listnet":       # the unmasked prediction softmax: pads get a gradient
        assert np.abs(x.grad.numpy()[target == -1]).max() > 1e-4


def test_impression_loss_unknown_name_raises():
    pred, target, P = _loss_inputs()
    with pytest.raises(ValueError, match="Undefined loss function: nope"):
        losses.impression_loss(torch.from_numpy(pred), torch.from_numpy(target), P, "nope")


@pytest.mark.parametrize("ties", [False, True])
def test_evaluate_impression_equals_jax(ties):
    rng = np.random.default_rng(3)
    B, P, N = 40, 3, 6
    pred = rng.normal(size=(B, P + N)).astype(np.float32)
    if ties:
        pred = np.round(pred)          # many ties between positives and negatives
    pos_num = rng.integers(1, P + 1, size=B)
    neg_num = rng.integers(1, N + 1, size=B)
    pos = pred[:, :P]
    pos[np.arange(P)[None, :] >= pos_num[:, None]] = -np.inf
    neg = pred[:, P:]
    neg[np.arange(N)[None, :] >= neg_num[:, None]] = -np.inf
    args = (pred, [1, 2, 5], ["NDCG", "HR", "MAP"], pos_num, neg_num, P)
    got, want = metrics.evaluate_impression(*args), jmetrics.evaluate_impression(*args)
    assert got.keys() == want.keys() and len(got) == 9
    for k in got:
        assert got[k] == want[k], k


@pytest.mark.parametrize("topk", [[1, 3, 5], [1, 3, 5, 10, 20, 50], [2, 9, 17], [5, 100]])
@pytest.mark.parametrize("ties", [False, True])
def test_evaluate_impression_equals_jax_on_wide_rows(ties, topk):
    """Full-catalog-like rows (20 positive slots, 700 negatives): the
    metrics equal the JAX package's bit for bit, for top-k sets from one
    column to past the row's positive slots."""
    rng = np.random.default_rng(5)
    B, P, N = 64, 20, 700
    pred = rng.normal(size=(B, P + N)).astype(np.float32)
    if ties:
        pred = np.round(pred * 2) / 2
    pos_num = rng.integers(1, P + 1, size=B)
    neg_num = rng.integers(1, N + 1, size=B)
    pred[:, :P][np.arange(P)[None, :] >= pos_num[:, None]] = -np.inf
    pred[:, P:][np.arange(N)[None, :] >= neg_num[:, None]] = -np.inf
    args = (pred, topk, ["NDCG", "HR", "MAP"], pos_num, neg_num, P)
    got, want = metrics.evaluate_impression(*args), jmetrics.evaluate_impression(*args)
    assert got.keys() == want.keys() and len(got) == 3 * len(topk)
    for k in got:
        assert got[k] == want[k], k


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_make_impression_dataset_writes_the_jax_files(tmp_path, noise):
    kw = dict(n_users=40, n_items=30, n_impressions=5, seed=4, noise=noise)
    assert synthetic.make_impression_dataset(str(tmp_path / "port"), **kw) == \
        jsynthetic.make_impression_dataset(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["dev.csv", "test.csv", "train.csv"]
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False), name


# ----------------------------------------------------------------- readers
def _frames_equal(df, jdf):
    assert list(df.columns) == list(jdf.columns)
    for c in df.columns:
        if c in ("pos_items", "neg_items"):
            assert len(df[c]) == len(jdf[c])
            for a, b in zip(df[c], jdf[c]):
                np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            np.testing.assert_array_equal(df[c].to_numpy(), jdf[c].to_numpy(), err_msg=c)


@pytest.mark.parametrize("case", ["synth", "edge_time", "edge_impression_id"])
@pytest.mark.parametrize("reader", ["ImpressionReader", "ImpressionSeqReader"])
def test_impression_readers_equal_jax(data_root, reader, case):
    dataset, idkey = {"synth": ("SynthImp", "time"), "edge_time": ("Edge", "time"),
                      "edge_impression_id": ("Edge", "impression_id")}[case]
    corpus, jcorpus = _pair(_args(data_root, dataset=dataset, impression_idkey=idkey), reader)
    assert (corpus.n_users, corpus.n_items) == (jcorpus.n_users, jcorpus.n_items)
    for k in ("train", "dev", "test"):
        _frames_equal(corpus.data_df[k], jcorpus.data_df[k])
        assert len(corpus.data_df[k]) > 0
    np.testing.assert_array_equal(corpus.pos_clicked_matrix(), jcorpus.pos_clicked_matrix())
    if case != "synth":
        # the edge corpus drops requests and filters id 0
        raw = pd.read_csv(os.path.join(data_root, "Edge", "train.csv"), sep="\t")
        assert 0 < len(corpus.data_df["train"]) < raw.groupby(["user_id", idkey]).ngroups
        assert not any(0 in x for k in ("pos_items", "neg_items") for x in corpus.data_df["train"][k])
    if reader == "ImpressionSeqReader":
        for tag in ("pos", "neg"):
            a, b = getattr(corpus.user_his, tag), getattr(jcorpus.user_his, tag)
            np.testing.assert_array_equal(a.flat, b.flat)
            np.testing.assert_array_equal(a.offsets, b.offsets)
        for k in ("train", "test"):
            got = corpus.dual_history_arrays(corpus.data_df[k], 4)
            want = jcorpus.dual_history_arrays(jcorpus.data_df[k], 4)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_impression_context_reader_equals_jax(data_root, tmp_path):
    root = tmp_path / "ctx"
    os.makedirs(root / "SynthImp")
    for n in ("train.csv", "dev.csv", "test.csv"):
        os.symlink(os.path.join(data_root, "SynthImp", n), root / "SynthImp" / n)
    n_items = SYNTH["n_items"]
    pd.DataFrame({"item_id": range(1, n_items + 1), "i_category_c": [i % 4 for i in range(1, n_items + 1)],
                  "i_price_f": np.linspace(0, 1, n_items)}).to_csv(
        root / "SynthImp" / "item_meta.csv", sep="\t", index=False)
    args = _args(str(root), include_item_features=1, include_user_features=0, include_context_features=0)
    corpus, jcorpus = _pair(args, "ImpressionContextReader")
    for k in ("train", "dev", "test"):
        _frames_equal(corpus.data_df[k], jcorpus.data_df[k])
    assert corpus.feature_max == jcorpus.feature_max and corpus.feature_max["i_category_c"] == 4
    assert corpus.item_feature_names == jcorpus.item_feature_names == ["i_category_c", "i_price_f"]


# ---------------------------------------------------------------- batchers
def _model_pair(name, corpus, jcorpus, args):
    return (registry.get_model(name).from_args(args, corpus),
            jregistry.get_model(name).from_args(args, jcorpus))


@pytest.mark.parametrize("phase,test_all", [("train", 0), ("dev", 0), ("test", 1)])
@pytest.mark.parametrize("name", ["BPRMFImpression", "GRU4RecImpression"])
def test_impression_batchers_equal_jax(data_root, name, phase, test_all):
    args = _args(data_root, test_all=test_all)
    cls = registry.get_model(name)
    corpus, jcorpus = _pair(args, cls.reader)
    model, jmodel = _model_pair(name, corpus, jcorpus, args)
    b = get_batcher(cls.batcher)(corpus, model, phase, args)
    jb = jget_batcher(cls.batcher)(jcorpus, jmodel, phase, args)
    assert type(b).__name__ == type(jb).__name__ and len(b) == len(jb) > 0
    assert (b.pos_len, b.neg_len, b.test_all) == (jb.pos_len, jb.neg_len, jb.test_all)
    assert b.arrays.keys() == jb.arrays.keys()
    for k in b.arrays:
        assert b.arrays[k].dtype == np.asarray(jb.arrays[k]).dtype, k
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    idx = np.sort(np.random.default_rng(0).choice(len(b), min(40, len(b)), replace=False))
    fn = "train_feed" if phase == "train" else "eval_feed"
    extra = (torch.Generator().manual_seed(0),) if phase == "train" else ()
    jextra = (jax.random.key(0),) if phase == "train" else ()
    feed = getattr(b, fn)(b.device_arrays("cpu"), torch.from_numpy(idx), *extra)
    jfeed = jax.jit(getattr(jb, fn))(jb.device_arrays(), jnp.asarray(idx, jnp.int32), *jextra)
    assert feed.keys() == jfeed.keys()
    for k in feed:
        if k == "batch_size":
            assert feed[k] == jfeed[k]
            continue
        np.testing.assert_array_equal(feed[k].numpy(), np.asarray(jfeed[k]), err_msg=k)
    if test_all:
        # neg_num = n_items - 1 - #clicked, every valid catalog column counted
        np.testing.assert_array_equal((feed["target"][:, b.pos_len:] == 0).sum(1).numpy(),
                                      feed["neg_num"].numpy())


# ------------------------------------------------------------------- models
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


def _built(root, name, phase="train", **kw):
    """(JAX model, its params (redrawn at O(0.3)), port model with the same
    weights, JAX feed, torch feed, port corpus, JAX corpus, args)."""
    args = _args(root, **kw)
    cls = registry.get_model(name)
    corpus, jcorpus = _pair(args, cls.reader)
    model, jmodel = _model_pair(name, corpus, jcorpus, args)
    jb = jget_batcher(cls.batcher)(jcorpus, jmodel, phase, args)
    idx = jnp.arange(min(24, len(jb)), dtype=jnp.int32)
    if phase == "train":
        jfeed = jax.jit(jb.train_feed)(jb.device_arrays(), idx, jax.random.key(0))
    else:
        jfeed = jax.jit(jb.eval_feed)(jb.device_arrays(), idx)
    variables = jax.jit(lambda f: jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                              f, training=False))(jfeed)
    params = jax.device_get(_redraw(variables["params"], 1))
    model.load_state_dict(weights.from_flax_params(params, name), strict=False)
    # the non-param collections (LightGCN's edge constants) ride with the params
    jmodel.extra_vars = {k: v for k, v in variables.items() if k != "params"}
    return jmodel, params, model, jfeed, _torch_feed(jfeed), corpus, jcorpus, args


@pytest.mark.parametrize("name", MODELS)
def test_impression_models_forward_loss_and_gradients_equal_flax(data_root, name):
    jmodel, params, model, jfeed, tfeed, *_ = _built(data_root, name, loss_n="softmaxCE")
    extra = jmodel.extra_vars
    want = jax.jit(lambda p, f: jmodel.apply({"params": p, **extra}, f, training=False))(params, jfeed)
    got = model(tfeed)
    assert set(want) == set(got) == {"prediction", "u_v", "i_v"}
    for key in want:
        assert tuple(got[key].shape) == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
    assert np.abs(np.asarray(want["prediction"])).max() > 0.05, "scores far above the tolerance"

    def jloss(p):
        return jmodel.loss(jmodel.apply({"params": p, **extra}, jfeed, training=True,
                                        rngs={"dropout": jax.random.key(2)}), jfeed)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = model.loss(model(tfeed, training=True, gen=torch.Generator().manual_seed(0)), tfeed)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= ATOL, (float(loss), float(jl))
    want_g = weights.from_flax_params(jax.device_get(jgrads), name)
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_impression_models_params_round_trip(data_root, name):
    _, params, model, *_ = _built(data_root, name)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(params))
    back = weights.to_flax_params(model.state_dict(), name)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("with_pads", [False, True])
def test_bilstm_equals_flax(with_pads):
    rng = np.random.default_rng(5)
    B, L, D, H = 6, 7, 5, 4
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    lengths = np.array([7, 3, 0, 1, 5, 7] if with_pads else [L] * B, np.int32)
    jm = jlayers.BiLSTM(H)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lengths))["params"]
    params = jax.device_get(_redraw(params, 2))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(lengths)))
    m = tlayers.BiLSTM(D, H)
    flat = {k: v for k, v in weights._leaves(params)}
    sd = {}
    for path, leaf in flat.items():
        cell = {"OptimizedLSTMCell_0": "fwd", "OptimizedLSTMCell_1": "bwd"}[path[0]]
        name = "weight" if path[-1] == "kernel" else "bias"
        arr = np.asarray(leaf).T if path[-1] == "kernel" else np.asarray(leaf)
        sd[f"{cell}.cell.{path[1]}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    m.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = m(xt, torch.from_numpy(lengths).long())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    jg = jax.grad(lambda xx: jm.apply({"params": params}, xx, jnp.asarray(lengths)).sum())(jnp.asarray(x))
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0, atol=ATOL)


def test_bilstm_initialisers_follow_flax():
    m = tlayers.BiLSTM(6, 32)
    gen = torch.Generator().manual_seed(0)
    for mod in m.modules():
        for pname, p in mod.named_parameters(recurse=False):
            with torch.no_grad():
                p.copy_(tlayers.param_init(mod, pname)(p.shape, gen))
    hi = m.fwd.cell.hi.weight
    torch.testing.assert_close(hi @ hi.T, torch.eye(32), atol=1e-5, rtol=0)   # orthogonal
    assert float(m.fwd.cell.hi.bias.abs().max()) == 0.0
    assert 0.2 < float(m.fwd.cell.ii.weight.std()) * np.sqrt(6) < 1.2         # lecun: var 1 / fan_in


# --------------------------------------------------------- runner & export
def _runner_pair(args, model_cls_name, **flags):
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    ns.__dict__.update(vars(args))
    ns.__dict__.update(metric="NDCG,HR,MAP", topk="1,3,5", main_metric="NDCG@3", eval_batch_size=16,
                       **flags)
    return (registry.get_runner(registry.get_model(model_cls_name).runner)(ns),
            jregistry.get_runner(jregistry.get_model(model_cls_name).runner)(ns), ns)


def _state_pair(root, name, test_all, **flags):
    """Port and JAX runner states with the same weights, and their test
    batchers and arrays; `flags` go to both runners."""
    jmodel, params, model, _, _, corpus, jcorpus, args = _built(root, name, test_all=test_all)
    runner, jrunner, ns = _runner_pair(args, name, **flags)
    cls = registry.get_model(name)
    b = {p: get_batcher(cls.batcher)(corpus, model, p, ns) for p in ("train", "test")}
    jb = {p: jget_batcher(cls.batcher)(jcorpus, jmodel, p, ns) for p in ("train", "test")}
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state = runner.init_state(model, 0, b["train"])
    model.load_state_dict(sd)
    jstate = jrunner.init_state(jmodel, jb["train"], 0)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    return (runner, state, b, {p: x.device_arrays(runner.device) for p, x in b.items()},
            jrunner, jstate, jmodel, jb, {p: x.device_arrays() for p, x in jb.items()}, ns, corpus, jcorpus)


@pytest.mark.parametrize("test_all", [0, 1])
@pytest.mark.parametrize("name", ["BPRMFImpression", "SASRecImpression"])
def test_runner_predict_and_metrics_equal_jax(data_root, name, test_all):
    runner, state, b, arr, jrunner, jstate, jmodel, jb, jarr, *_ = _state_pair(data_root, name, test_all)
    got = runner.predict(state, b["test"], arr["test"], "test")
    want = jrunner.predict(jstate, jmodel, jb["test"], jarr["test"], "test")
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(np.asarray(want[0])))
    fin = np.isfinite(got[0])
    np.testing.assert_allclose(got[0][fin], np.asarray(want[0])[fin], rtol=0, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))
    topks, mets = [1, 3, 5], ["NDCG", "HR", "MAP"]
    res = runner.evaluate(state, b["test"], arr["test"], "test", topks, mets)
    jres = jrunner.evaluate(jstate, jmodel, jb["test"], jarr["test"], "test", topks, mets)
    for k in jres:
        assert abs(res[k] - jres[k]) <= 1e-9, (k, res[k], jres[k])


@pytest.mark.parametrize("test_all", [0, 1])
def test_export_equals_jax(data_root, tmp_path, test_all):
    runner, state, b, arr, jrunner, jstate, jmodel, jb, jarr, ns, corpus, jcorpus = \
        _state_pair(data_root, "BPRMFImpression", test_all)
    outs = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        os.makedirs(d / "SynthImp", exist_ok=True)
        sargs = argparse.Namespace(**{**vars(ns), "path": str(d)})
        if side == "port":
            port_main.save_rec_results(sargs, corpus, runner, state, {"test": b["test"]},
                                       {"test": arr["test"]}, topk=10)
        else:
            jmain.save_rec_results(sargs, jcorpus, jmodel, jrunner, jstate, {"test": jb["test"]},
                                   {"test": jarr["test"]}, topk=10)
        outs[side] = pd.read_csv(d / "SynthImp" / "rec-BPRMFImpression-test.csv", sep="\t")
    got, want = outs["port"], outs["jax"]
    assert list(got.columns) == list(want.columns)
    assert list(got.columns) == ["user_id", "pos_items", "pos_predictions"] + (
        ["rec_items", "rec_predictions"] if test_all else ["neg_items", "neg_predictions"])
    for c in got.columns:
        if c.endswith("predictions"):
            for g, w in zip(got[c], want[c]):
                np.testing.assert_allclose(eval(g), eval(w), rtol=0, atol=1e-4 + ATOL, err_msg=c)
        else:
            assert got[c].tolist() == want[c].tolist(), c
    if test_all:
        assert all(len(eval(r)) == 10 and 0 not in eval(r) for r in got["rec_items"])


# ---------------------------------------------------------------- lazy lane
def _one_step(root, name, lazy_flags):
    """One train step of each runner from the same weights on the same rows
    (port: BaseRunner.train_step; JAX: its step function), in the lazy
    lane. Returns (port params, JAX params as a state_dict, port runner)."""
    runner, state, b, arr, jrunner, jstate, jmodel, jb, jarr, ns, *_ = _state_pair(root, name, 0,
                                                                                      **lazy_flags)
    idx = np.arange(min(16, len(b["train"])))
    runner.train_step(state, b["train"], arr["train"], torch.from_numpy(idx), torch.Generator().manual_seed(0))
    box = {"paths": set()}
    step_fn = jrunner._build_step_fn(jmodel, jb["train"], jrunner._tx, box)
    jstate, _ = step_fn(jrunner.place_arrays(jarr["train"]), jstate,
                        (jnp.asarray(idx, jnp.int32), jax.random.key(0)))
    want = weights.from_flax_params(jax.device_get(jstate.params), name)
    return {k: v.detach() for k, v in state.model.state_dict().items()}, want, runner


@pytest.mark.parametrize("name", ["BPRMFImpression", "SASRecImpression"])
def test_lazy_step_equals_jax(data_root, name):
    """The sparse-grad lazy lane (three-scatter: one Adam commit per table
    per step, what a packed epoch commits too) from the same weights:
    BPRMFImpression's user and item tables over item_id [B, P + N] with pad
    id 0 in it; SASRecImpression's item table over item_id only, its
    history rows read without gradient as in the JAX package."""
    got, want, runner = _one_step(data_root, name, dict(lazy_emb_adam=1, packed_opt_rows=0))
    assert set(runner._lazy_specs) == {"u_embeddings.weight", "i_embeddings.weight"}
    assert float((got["i_embeddings.weight"] - want["i_embeddings.weight"]).abs().max()) < 1e-6
    # the key projection's bias shifts every score of a row alike, so its
    # true gradient is 0 and both sides hold f32 rounding noise there, which
    # Adam's first step divides by itself: it is left out
    for k in (k for k in want if not k.endswith("mha.k.bias")):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_lightgcn_impression_lazy_lane_raises_the_jax_error(data_root, tmp_path):
    args = ["--model_name", "LightGCN", "--model_mode", "Impression", "--emb_size", "8", "--gpu", "",
            "--path", data_root, "--dataset", "SynthImp", "--epoch", "1", "--lazy_emb_adam", "1",
            "--log_file", str(tmp_path / "l.log"), "--model_path", str(tmp_path / "l.bin"),
            "--save_final_results", "0", "--regenerate", "1"]
    with pytest.raises(ValueError, match="lazy_table_specs matched no param/feed keys"):
        port_main.build_parser_and_run(args)


# --------------------------------------------------------------- learning
LEARN = {"BPRMFImpression": ["--loss_n", "BPR"], "BPRMFImpression-listnet": ["--loss_n", "listnet"],
         "BPRMFImpression-softmaxCE": ["--loss_n", "softmaxCE"],
         "BPRMFImpression-attention_rank": ["--loss_n", "attention_rank"],
         "BPRMFImpression-BPRhard": ["--loss_n", "BPRhard"],
         "LightGCNImpression": ["--n_layers", "2"],
         "GRU4RecImpression": ["--hidden_size", "16"],
         "SASRecImpression": ["--num_layers", "1", "--num_heads", "2"]}


@pytest.mark.parametrize("case", list(LEARN))
def test_impression_models_learn_through_the_cli(data_root, tmp_path, case):
    """The JAX package's learning test (tests/test_e2e_impression.py:46-66)
    through this package's CLI on SynthImp: positives are the user's group
    items, so a learner ranks them above the negatives."""
    name = case.split("-")[0]
    argv = ["--model_name", name[: -len("Impression")], "--model_mode", "Impression", *LEARN[case],
            "--emb_size", "16", "--lr", "1e-2", "--l2", "0", "--batch_size", "128", "--eval_batch_size", "128",
            "--epoch", "15", "--early_stop", "40", "--topk", "2,5", "--metric", "NDCG,HR,MAP",
            "--train_max_pos_item", "5", "--train_max_neg_item", "8", "--test_max_pos_item", "5",
            "--test_max_neg_item", "8", "--history_max", "10", "--random_seed", "5", "--gpu", "",
            "--path", data_root, "--dataset", "SynthImpLearn", "--log_file", str(tmp_path / "r.log"),
            "--model_path", str(tmp_path / "r.bin"), "--save_final_results", "0"]
    port_main.build_parser_and_run(argv)
    text = open(tmp_path / "r.log").read()
    line = [ln for ln in text.splitlines() if ln.startswith("Test After Training")][-1]
    res = {k: float(v) for k, v in (kv.split(":") for kv in line[line.index("(") + 1: -1].split(","))}
    assert set(res) == {"NDCG@2", "HR@2", "MAP@2", "NDCG@5", "HR@5", "MAP@5"}
    assert res["NDCG@2"] > 0.5, f"{case}: {res}"
