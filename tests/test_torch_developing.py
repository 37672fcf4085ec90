"""The developing models in the port (CLRec, FourierTA, SRGNN, S3Rec in both
stages) against the JAX package on the same inputs: forward outputs,
losses and every gradient with the weights carried across
(`weights.from_flax_params`), `#params` and the flax -> torch -> flax round
trip; `build_session_graph` and `GatedGNN`; the `seq_delta` and `s3rec`
batchers' arrays and deterministic feeds, and the stage-1 feed's
invariants; the lazy lane of each model as the JAX CLI runs it; and,
through the port's runner, tests/test_e2e_developing.py's learning bars.

Small sizes: D = 16, history 6 (8 in the learning runs), 2 blocks of 2
heads. Weights are redrawn from numpy at O(0.3) so that activations are
O(1). Tolerance 1e-5 absolute and 1e-5 relative for forward values,
losses and gradients (f32 products and sums in two libraries); feeds are
compared exactly, except `history_delta_t`, within 2 ulp (the division
before the log2 may round differently under XLA, as in KDA's feeds).
S3Rec's encoder drops its input at a fixed 0.2 in training, so its
comparison runs with training off (no dropout) in both packages, and its
training path once more with one fixed dropout mask put into both.
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
from rechorus_tpu.data import readers as jreaders
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.models.developing import srgnn as jsrgnn
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import readers, synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.models.developing import srgnn as tsrgnn
from rechorus_tpu_torch.models.sequential import contrarec as tcontrarec
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.runners import base as tbase

ATOL = RTOL = 1e-5
DEVELOPING = ["CLRec", "FourierTA", "SRGNN", "S3Rec"]
BASE = dict(num_neg=2, dropout=0.0, test_all=0, emb_size=16, history_max=6, host_shard_input=0,
            gpu="", random_seed=0, dataset="Synth")
CASES = {  # case -> (registered name, overrides)
    "CLRec": ("CLRec", dict(temp=0.3)),
    "FourierTA": ("FourierTA", dict(t_scalar=3600)),
    "SRGNN": ("SRGNN", dict(num_layers=2)),
    "S3Rec-1": ("S3Rec", dict(stage=1, mask_ratio=0.3)),
    "S3Rec-2": ("S3Rec", dict(stage=2)),
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


def _reader_args(root):
    return argparse.Namespace(path=str(root), dataset="Synth", sep="\t", regenerate=0)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(port SeqReader, JAX SeqReader) over tests/test_e2e_developing.py's corpus."""
    root = tmp_path_factory.mktemp("developing")
    synthetic.make_topk_dataset(str(root / "Synth"), n_users=150, n_items=80, n_per_user=10)
    args = _reader_args(root)
    return readers.SeqReader(args), jreaders.SeqReader(args)


def _model_args(name, tmp="", **kw):
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


def _build(synth, tmp_path, case):
    """(JAX model, params, port model with the same weights, JAX train
    feed, torch train feed, JAX dev feed, torch dev feed)."""
    name, kw = CASES[case]
    jcls, cls = jregistry.get_model(name), registry.get_model(name)
    corpus, jcorpus = synth
    jmodel = jcls.from_args(_model_args(name, tmp_path, **kw), jcorpus)
    model = cls.from_args(_model_args(name, tmp_path, **kw), corpus)
    args = _model_args(name, tmp_path, **kw)
    jb = jget_batcher(jcls.batcher)(jcorpus, jmodel, "train", args)
    jfeed = jax.jit(jb.train_feed)(jb.device_arrays(), jnp.arange(32, dtype=jnp.int32), jax.random.key(3))
    jdev_b = jget_batcher(jcls.batcher)(jcorpus, jmodel, "dev", args)
    jdev = jax.jit(jdev_b.eval_feed)(jdev_b.device_arrays(), jnp.arange(24, dtype=jnp.int32))
    params = jax.jit(lambda f: jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                           f, training=True))(jfeed)["params"]
    params = jax.device_get(_redraw(params, 1))
    model.load_state_dict(weights.from_flax_params(params, name), strict=True)
    return jmodel, params, model, jfeed, _torch_feed(jfeed), jdev, _torch_feed(jdev)


@pytest.fixture(scope="module", params=list(CASES))
def built(request, synth, tmp_path_factory):
    return (request.param,) + _build(synth, tmp_path_factory.mktemp("built"), request.param)


def test_forward_loss_and_gradients_equal_flax(built):
    case, jmodel, params, model, jfeed, tfeed, jdev, tdev = built
    name = CASES[case][0]
    training = name != "S3Rec"
    rngs = {"dropout": jax.random.key(2)}
    want = jax.jit(lambda p, f: jmodel.apply({"params": p}, f, training=training, rngs=rngs))(params, jfeed)
    got = model(tfeed, training=training, gen=torch.Generator().manual_seed(0))
    assert set(want) == set(got), (set(want), set(got))
    for key in want:
        g, w = got[key].detach().numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=key)

    def jloss(p):
        return jmodel.loss(jmodel.apply({"params": p}, jfeed, training=training, rngs=rngs), jfeed)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = model.loss(model(tfeed, training=training, gen=torch.Generator().manual_seed(0)), tfeed)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL, atol=ATOL)
    want_g = weights.from_flax_params(jax.device_get(jgrads), name)
    got_g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    assert max(float(g.abs().max()) for g in got_g.values()) > 1e-3
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)

    # evaluation: the dev feed's [target | negatives] scores
    want = np.asarray(jax.jit(lambda p, f: jmodel.apply({"params": p}, f, training=False))(
        params, jdev)["prediction"])
    with torch.no_grad():
        got = model(tdev)["prediction"].numpy()
    assert got.shape == want.shape and got.shape[0] == 24
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 0.1, "O(1) scores"


def _fixed_keep(shape, rate):
    """A mask that keeps about 1 - rate of the elements, the same in both
    packages for a shape."""
    return (np.arange(int(np.prod(shape))).reshape(shape) * 7919 % 100) >= int(round(rate * 100))


class _FixedMaskDropout(flax.linen.Module):
    """flax `nn.Dropout` with `_fixed_keep`'s mask in place of a draw."""
    rate: float
    deterministic: bool = None

    def __call__(self, x, deterministic=None):
        if flax.linen.merge_param("deterministic", self.deterministic, deterministic) or self.rate == 0.0:
            return x
        return jnp.where(_fixed_keep(x.shape, self.rate), x / (1.0 - self.rate), 0.0)


def _fixed_mask_dropout(x, rate, training, gen):
    """The port's `layers.dropout` with `_fixed_keep`'s mask."""
    if not training or rate == 0.0:
        return x
    keep = torch.from_numpy(_fixed_keep(tuple(x.shape), rate))
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("case", ["S3Rec-1", "S3Rec-2"])
def test_s3rec_training_path_with_one_dropout_mask_equals_flax(synth, tmp_path, monkeypatch, case):
    """S3Rec in training, its encoder's input dropout (0.2) drawing one
    fixed mask in both packages: the dropout sits where the JAX package's
    does, with its scale, and forward, loss and every gradient agree."""
    jmodel, params, model, jfeed, tfeed, _, _ = _build(synth, tmp_path, case)
    monkeypatch.setattr(flax.linen, "Dropout", _FixedMaskDropout)
    monkeypatch.setattr(tcontrarec, "dropout", _fixed_mask_dropout)
    monkeypatch.setattr(tlayers, "dropout", _fixed_mask_dropout)

    def jloss(p):
        out = jmodel.apply({"params": p}, jfeed, training=True)
        return jmodel.loss(out, jfeed), out

    (jl, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    with torch.no_grad():
        off = model(tfeed, training=False)
    got = model(tfeed, training=True)
    key = "mip_dis" if case == "S3Rec-1" else "prediction"
    assert not torch.allclose(got[key], off[key], rtol=RTOL, atol=ATOL), "the mask changes the output"
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    loss = model.loss(got, tfeed)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL, atol=ATOL)
    want_g = weights.from_flax_params(jax.device_get(jgrads), "S3Rec")
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def test_params_round_trip(built):
    case, jmodel, params, model, *_ = built
    name = CASES[case][0]
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    back = weights.to_flax_params(model.state_dict(), name)
    flat, flat_back = (flax.traverse_util.flatten_dict(t) for t in (params, back))
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))


def test_srgnn_row_zero_takes_no_gradient_and_keeps_its_value(synth, tmp_path):
    _, _, model, _, tfeed, _, _ = _build(synth, tmp_path, "SRGNN")
    before = model.i_embeddings.detach().clone()
    assert float(before[0].abs().sum()) > 0
    loss = model.loss(model(tfeed, training=True), tfeed)
    loss.backward()
    assert torch.equal(model.i_embeddings.grad[0], torch.zeros_like(before[0]))
    assert float(model.i_embeddings.grad[1:].abs().sum()) > 0
    assert torch.equal(model.i_embeddings.detach(), before)


def test_registry_args_and_lazy_specs_equal_jax():
    names = lambda p: {a.dest: a.default for a in p._actions}       # noqa: E731
    for name in DEVELOPING:
        jm, m = jregistry.get_model(name), registry.get_model(name)
        assert names(jm.parse_model_args(argparse.ArgumentParser())) == \
            names(m.parse_model_args(argparse.ArgumentParser())), name
        assert jm.extra_log_args == m.extra_log_args, name
        assert (jm.reader, jm.runner, jm.batcher) == (m.reader, m.runner, m.batcher), name
        assert jm.train_with_neg == m.train_with_neg and jm.supports_catalog == m.supports_catalog


@pytest.mark.parametrize("case", list(CASES))
def test_lazy_table_specs_equal_jax(synth, tmp_path, case):
    """The same tables, gathered by the same feed keys: CLRec's item table
    only; SRGNN's and FourierTA's raw tables match no spec; S3Rec opts out."""
    jmodel, params, model, *_ = _build(synth, tmp_path, case)
    name = CASES[case][0]
    flat = flax.traverse_util.flatten_dict(params)
    want = {weights._torch_leaf(name, path)[0]: keys for path, keys in jmodel.lazy_table_specs().items()
            if path in flat}
    own = dict(model.named_parameters())
    got = {k: v for k, v in model.lazy_table_specs().items() if k in own}
    assert got == want
    assert bool(got) == (name == "CLRec")


# -------------------------------------------------------- session graph
GRAPH_ROWS = np.array([
    [3, 1, 3, 2, 0, 0],      # a repeat, pads
    [5, 0, 0, 0, 0, 0],      # length 1
    [4, 7, 9, 2, 8, 6],      # no pads, no repeat
    [2, 2, 2, 5, 2, 5],      # repeats only, self-loops, no pads
    [1, 9, 1, 9, 1, 0],      # a cycle
    [0, 0, 0, 0, 0, 0],      # empty
    [6, 3, 5, 1, 3, 6],      # the smallest item at node 0 (no pads)
], dtype=np.int32)


def test_build_session_graph_equals_jax():
    want = [np.asarray(x) for x in jax.jit(jsrgnn.build_session_graph)(jnp.asarray(GRAPH_ROWS))]
    got = [x.numpy() for x in tsrgnn.build_session_graph(torch.from_numpy(GRAPH_ROWS).long())]
    for g, w, what in zip(got, want, ("alias", "A", "nodes")):
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=what)
    alias, A, nodes = got
    np.testing.assert_array_equal(np.take_along_axis(nodes, alias, axis=1), GRAPH_ROWS)
    assert (A[0] > 0).any() and not A[5].any() and not A[1].any()


def test_build_session_graph_equals_jax_on_random_rows():
    rng = np.random.default_rng(0)
    B, H = 64, 10
    lengths = rng.integers(0, H + 1, size=B)
    hist = np.where(np.arange(H)[None, :] < lengths[:, None], rng.integers(1, 8, size=(B, H)), 0)
    want = [np.asarray(x) for x in jax.jit(jsrgnn.build_session_graph)(jnp.asarray(hist, jnp.int32))]
    got = [x.numpy() for x in tsrgnn.build_session_graph(torch.from_numpy(hist).long())]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_gated_gnn_equals_flax():
    rng = np.random.default_rng(1)
    d, B, H = 8, 5, 6
    jgnn = jsrgnn.GatedGNN(d, 2)
    A = jsrgnn.build_session_graph(jnp.asarray(GRAPH_ROWS[:B]))[1]
    hidden = rng.normal(size=(B, H, d)).astype(np.float32)
    params = jax.device_get(_redraw(jgnn.init(jax.random.key(0), A, jnp.asarray(hidden))["params"], 4))
    want = np.asarray(jgnn.apply({"params": params}, A, jnp.asarray(hidden)))
    gnn = tsrgnn.GatedGNN(d, 2)
    state = weights.from_flax_params({"gnn": params}, "SRGNN")
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = gnn(torch.from_numpy(np.array(A)), torch.from_numpy(hidden)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -------------------------------------------------------------- batchers
def _pair(synth, tmp_path, bname, name, phase, **kw):
    corpus, jcorpus = synth
    args = _model_args(name, tmp_path, **kw)
    jmodel = jregistry.get_model(name).from_args(args, jcorpus)
    model = registry.get_model(name).from_args(args, corpus)
    return get_batcher(bname)(corpus, model, phase, args), jget_batcher(bname)(jcorpus, jmodel, phase, args)


@pytest.mark.parametrize("phase,test_all", [("train", 0), ("dev", 0), ("test", 0), ("test", 1)])
@pytest.mark.parametrize("bname,name,kw", [("seq_delta", "FourierTA", dict(t_scalar=3600)),
                                           ("s3rec", "S3Rec", dict(stage=1)),
                                           ("s3rec", "S3Rec", dict(stage=2))],
                         ids=["seq_delta", "s3rec-1", "s3rec-2"])
def test_batcher_arrays_and_feeds_equal_jax(synth, tmp_path, bname, name, kw, phase, test_all):
    """The host arrays (stage 1: the chunk rows and the long stream) and the
    deterministic feeds (every dev / test feed; the train feeds but their
    negatives) of the port's batcher equal the JAX package's."""
    b, jb = _pair(synth, tmp_path, bname, name, phase, test_all=test_all, num_neg=1, **kw)
    assert b.arrays.keys() == jb.arrays.keys() and len(b) == len(jb)
    for k in b.arrays:
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    if phase == "train" and kw.get("stage") == 1:
        assert {"item_seq", "seq_len", "long_seq"} <= set(b.arrays)
        return
    arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
    idx = np.sort(np.random.default_rng(0).choice(len(b), min(48, len(b)), replace=False))
    if phase == "train":
        feed = b.train_feed(arrays, torch.from_numpy(idx), torch.Generator().manual_seed(0))
        jfeed = jax.jit(jb.train_feed)(jarrays, jnp.asarray(idx, jnp.int32), jax.random.key(0))
        skip = {"item_id", "batch_size"}     # the sampled negatives differ by library
        np.testing.assert_array_equal(feed["item_id"][:, 0].numpy(), np.asarray(jfeed["item_id"])[:, 0])
    else:
        feed = b.eval_feed(arrays, torch.from_numpy(idx))
        jfeed = jax.jit(jb.eval_feed)(jarrays, jnp.asarray(idx, jnp.int32))
        skip = {"batch_size"}
    assert set(feed) == set(jfeed)
    for k, v in jfeed.items():
        if k in skip:
            continue
        got, want = feed[k].numpy(), np.asarray(v)
        assert got.shape == want.shape, k
        if k == "history_delta_t":
            np.testing.assert_array_max_ulp(got, want, maxulp=2)
            assert (got > 0).mean() > 0.5
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)


def test_s3rec_stage1_feed_invariants(synth, tmp_path):
    """MIP: masked positions only within the length, at about mask_ratio;
    each masked position's negative absent from the whole row, every other
    position's `neg_item` its own item. SP: a row of length < 2 keeps
    copies; otherwise one contiguous span inside the length, of 1 to
    len // 2 items, is the mask token in `mask_seg_seq` and the row's items
    in `pos_seg` (the mask token elsewhere in the length, the pads kept),
    and `neg_seg` holds there a contiguous slice of the long stream. The
    draws come from the step's generator only."""
    b, _ = _pair(synth, tmp_path, "s3rec", "S3Rec", "train", stage=1, mask_ratio=0.3)
    corpus, _ = synth
    token = corpus.n_items
    arrays = b.device_arrays("cpu")
    # the corpus's chunks are 6 or 4 long: add rows of length 1, 2 and 3
    H = arrays["item_seq"].shape[1]
    extra = torch.zeros(3, H, dtype=torch.long)
    extra[0, :1], extra[1, :2], extra[2, :3] = torch.tensor([5]), torch.tensor([7, 3]), torch.tensor([2, 9, 4])
    arrays["item_seq"] = torch.cat([arrays["item_seq"], extra])
    arrays["seq_len"] = torch.cat([arrays["seq_len"], torch.tensor([1, 2, 3])])
    idx = torch.arange(len(b) + 3)
    state = torch.random.get_rng_state()
    feed = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in b.train_feed(arrays, idx, torch.Generator().manual_seed(5)).items()}
    assert torch.equal(torch.random.get_rng_state(), state), "no draw from the global generator"
    again = b.train_feed(arrays, idx, torch.Generator().manual_seed(5))
    assert all(np.array_equal(again[k].numpy(), feed[k]) for k in feed if k != "batch_size")
    seq, L = arrays["item_seq"].numpy(), arrays["seq_len"].numpy()
    long_seq = arrays["long_seq"].numpy()
    valid = np.arange(H)[None, :] < L[:, None]
    np.testing.assert_array_equal(feed["pos_item"], seq)
    np.testing.assert_array_equal(feed["seq_len"], L)
    masked = feed["mask_seq"] == token
    assert not (masked & ~valid).any() and 0.2 < masked[valid].mean() < 0.4
    np.testing.assert_array_equal(feed["mask_seq"][~masked], seq[~masked])
    neg = feed["neg_item"]
    np.testing.assert_array_equal(neg[~masked], seq[~masked])
    in_row = (neg[:, :, None] == seq[:, None, :]).any(-1)
    assert not (in_row & masked).any() and ((neg >= 1) & (neg < token))[masked].all()
    for r in range(len(seq)):
        n = L[r]
        if n < 2:
            for k in ("mask_seg_seq", "pos_seg", "neg_seg"):
                np.testing.assert_array_equal(feed[k][r], seq[r])
            continue
        span = np.nonzero(feed["mask_seg_seq"][r] == token)[0]
        assert 1 <= len(span) <= max(n // 2, 1) and span[-1] < n
        assert (np.diff(span) == 1).all()
        np.testing.assert_array_equal(feed["mask_seg_seq"][r][np.setdiff1d(np.arange(H), span)],
                                      seq[r][np.setdiff1d(np.arange(H), span)])
        pos_seg = np.where(np.isin(np.arange(H), span) | (np.arange(H) >= n), seq[r], token)
        np.testing.assert_array_equal(feed["pos_seg"][r], pos_seg)
        out = np.setdiff1d(np.arange(H), span)
        np.testing.assert_array_equal(feed["neg_seg"][r][out], pos_seg[out])
        seg = feed["neg_seg"][r][span]
        windows = np.lib.stride_tricks.sliding_window_view(long_seq, len(seg))
        assert (windows == seg[None, :]).all(1).any(), r
    assert (L < 2).any() and (L >= 2).any()


# ------------------------------------------------------------ lazy lane
def _runner_args(**kw):
    args = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args.__dict__.update(gpu="", random_seed=0, **kw)
    return args


JAX_LAZY_ERROR = "lazy_table_specs matched no param/feed keys"


@pytest.mark.parametrize("case", list(CASES))
def test_lazy_lane_as_the_jax_cli(synth, tmp_path, case, caplog):
    """`--lazy_emb_adam 1`, as the JAX CLI runs these models on a CPU: CLRec
    commits its item table lazily; SRGNN's and FourierTA's first step raises
    the JAX package's ValueError; S3Rec warns that it declares no lazy
    tables and trains dense, in both stages."""
    name, kw = CASES[case]
    corpus, _ = synth
    args = _model_args(name, tmp_path, **kw)
    model = registry.get_model(name).from_args(args, corpus)
    runner = tbase.BaseRunner(_runner_args(lazy_emb_adam=1, batch_size=64))
    batcher = get_batcher(model.batcher)(corpus, model, "train", args)
    arrays = batcher.device_arrays("cpu")
    with caplog.at_level(logging.WARNING):
        state = runner.init_state(model, 0, batcher)
    if name in ("SRGNN", "FourierTA"):
        with pytest.raises(ValueError, match=JAX_LAZY_ERROR):
            runner.fit(state, batcher, arrays, 1, max_steps=1)
        assert state.step == 0
        return
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loss = runner.fit(state, batcher, arrays, 1, max_steps=2)
    assert np.isfinite(loss) and state.step == 2
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    if name == "CLRec":
        assert runner._lazy_specs and "i_embeddings.weight" in moved
        assert isinstance(runner._tx, tbase.LA.LazyAdamTx)
    else:
        assert "S3Rec declares no lazy tables" in caplog.text
        assert isinstance(runner._tx, tbase.DenseOptimizer) and "i_embeddings.weight" in moved


# ------------------------------------------------------ learning bars
def _learn_args(tmp_path, **over):
    base = dict(epoch=4, check_epoch=0, test_epoch=-1, early_stop=10, lr=1e-2, l2=0.0,
                batch_size=128, eval_batch_size=128, optimizer="Adam", topk="5", metric="NDCG,HR",
                main_metric="", model_path="", random_seed=7, dataset="Synth", num_neg=1, dropout=0.0,
                test_all=0, emb_size=16, history_max=8, gpu="", host_shard_input=0)
    base.update(over)
    args = _runner_args()
    args.__dict__.update(base)
    return args


def _learn(synth, name, args):
    corpus, _ = synth
    defaults = vars(registry.get_model(name).parse_model_args(argparse.ArgumentParser()).parse_args([]))
    for k, v in defaults.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    model = registry.get_model(name).from_args(args, corpus)
    runner = tbase.BaseRunner(args)
    runner.model_path = args.model_path
    batchers = {p: get_batcher(model.batcher)(corpus, model, p, args) for p in ("train", "dev", "test")}
    arrays = {p: b.device_arrays(runner.device) for p, b in batchers.items()}
    state = runner.train(batchers, runner.init_state(model, args.random_seed, batchers["train"]), arrays)
    return runner.evaluate(state, batchers["test"], arrays["test"], "test", [5], ["HR", "NDCG"])


@pytest.mark.parametrize("name,over,bar", [
    ("CLRec", dict(temp=0.2, epoch=6, batch_size=256), 0.35),
    ("FourierTA", dict(t_scalar=3600, epoch=8, lr=2e-2), 0.25),
    ("SRGNN", dict(num_layers=1, epoch=5), 0.30),
])
def test_learns_past_the_jax_bar(synth, tmp_path, name, over, bar):
    """tests/test_e2e_developing.py's runs and bars, through the port's runner."""
    res = _learn(synth, name, _learn_args(tmp_path, **over))
    assert np.isfinite(res["HR@5"]) and res["HR@5"] > bar, res


def test_s3rec_two_stages_learn(synth, tmp_path, caplog):
    common = dict(mip_weight=0.2, sp_weight=0.5, mask_ratio=0.3, lr=5e-3,
                  model_path=str(tmp_path / "S3Rec" / "x.bin"))
    with caplog.at_level(logging.INFO):
        res1 = _learn(synth, "S3Rec", _learn_args(tmp_path, stage=1, epoch=3, **common))
    assert np.isfinite(res1["HR@5"])
    pre = tmp_path / "S3Rec" / "Pre__Synth.bin"
    assert sorted(os.listdir(tmp_path / "S3Rec")) == ["Pre__Synth.bin"]
    with caplog.at_level(logging.INFO):
        res2 = _learn(synth, "S3Rec", _learn_args(tmp_path, stage=2, epoch=5, **common))
    assert f"Load pretrained S3Rec from {pre}" in caplog.text
    assert np.isfinite(res2["HR@5"]) and res2["HR@5"] > 0.30, res2
