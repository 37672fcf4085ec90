"""The context_seq family of the port (DIN, DIEN, CAN, ETA, SDIM in CTR and
TopK modes) against the JAX package on the same inputs: `ContextSeqReader`
and its two batchers (arrays and feeds equal), DIEN's negative history;
the layers `Dice`, `AttentionalGRU` (AGRU, AUGRU, AIGRU) and
`MultiHeadTargetAttention`; ETA's SimHash top-k on a tie-heavy input
(the retrieved rows equal `lax.top_k`'s in both --ref_retrieval modes) and
SDIM's collision attention; the forward, the training loss (BatchNorm
statistics and DIEN's auxiliary loss included), every gradient and the
moved statistics of each class and variant after `weights.
from_flax_params`; and two CLI runs and DINCTR's lift (the JAX package's
bar, tests/test_e2e_context_seq.py:55-56) through the port on the CPU.

Small sizes: emb 8, history 6-10, 2-3 candidates, a 60-user x 50-item
synthetic corpus with user, item (one float) and situation features.
Weights are redrawn from numpy at O(0.2), so a mismatch cannot hide under
tiny init values. Dropout is 0 where outputs are compared (the port draws
its masks from torch's generator). Tolerance: 1e-5 absolute plus 1e-5
relative (f32 sums in two libraries).
"""
import argparse
import logging
import re
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.data.readers import ContextSeqReader as JaxContextSeqReader
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.models.context_seq.eta import ETABase as JaxETABase
from rechorus_tpu.models.context_seq.sdim import SDIMBase as JaxSDIMBase
from rechorus_tpu.ops import layers as jlayers
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import _maybe_neg_history, get_batcher
from rechorus_tpu_torch.data.readers import ContextSeqReader
from rechorus_tpu_torch.models.context_seq.eta import ETABase
from rechorus_tpu_torch.models.context_seq.sdim import SDIMBase
from rechorus_tpu_torch.ops.layers import AttentionalGRU, Dice, MultiHeadTargetAttention
from rechorus_tpu_torch.runners import base as tbase

TOL = dict(rtol=1e-5, atol=1e-5)
EMB, B, C_TOPK, H = 8, 12, 3, 8
JOINT = dict(short_target_field='[("item_id","i_category_c")]',
             short_sequence_field='[("history_item_id","history_i_category_c")]',
             long_target_field='[("item_id","i_category_c")]',
             long_sequence_field='[("history_item_id","history_i_category_c")]')
# (model, mode, flags): the CLI's defaults of the flags not named
CASES = [
    ("DIN", "CTR", dict(att_layers="[6]", dnn_layers="[8,4]")),
    ("DIN", "TopK", dict(att_layers="[6,4]", dnn_layers="[8]", add_historical_situations=1)),
    ("DIN", "CTR", dict(att_layers="[6]", dnn_layers="[8]", add_historical_situations=1)),
    ("DIN", "TopK", dict(att_layers="[6]", dnn_layers="[8]")),
    ("DIEN", "CTR", dict(evolving_gru_type="AGRU", fcn_hidden_layers="[8]", aux_hidden_layers="[6]",
                         alpha_aux=0.5)),
    ("DIEN", "TopK", dict(evolving_gru_type="AUGRU", fcn_hidden_layers="[8]", aux_hidden_layers="[6]",
                          alpha_aux=0.1, add_historical_situations=1)),
    ("DIEN", "CTR", dict(evolving_gru_type="AIGRU", fcn_hidden_layers="[8,4]", alpha_aux=0.0,
                         add_historical_situations=1)),
    ("DIEN", "TopK", dict(evolving_gru_type="AIGRU", fcn_hidden_layers="[8]", aux_hidden_layers="[6]",
                          alpha_aux=0.3)),
    ("CAN", "CTR", dict(evolving_gru_type="AUGRU", fcn_hidden_layers="[8]", aux_hidden_layers="[6]",
                        alpha_aux=0.1, induce_vec_size=96, orders=1, co_action_layers="[4,4]")),
    ("CAN", "TopK", dict(evolving_gru_type="AIGRU", fcn_hidden_layers="[8]", alpha_aux=0.0,
                         induce_vec_size=200, orders=2, co_action_layers="[4,3]")),
    ("ETA", "CTR", dict(dnn_hidden_units="[8]", attention_dim=8, num_heads=2, retrieval_k=3,
                        hash_bits=2, recent_k=3, batch_norm=1, **JOINT)),
    ("ETA", "TopK", dict(dnn_hidden_units="[8]", attention_dim=6, retrieval_k=3, hash_bits=3,
                         num_hashes=2, recent_k=2, use_qkvo=0, ref_retrieval=1)),
    ("SDIM", "CTR", dict(dnn_hidden_units="[8]", attention_dim=8, hash_bits=2, num_hashes=2,
                         recent_k=3, **JOINT)),
    ("SDIM", "TopK", dict(dnn_hidden_units="[8,4]", attention_dim=8, hash_bits=2, num_hashes=3,
                          recent_k=3, batch_norm=1)),
]
IDS = [f"{m}{mode}-" + ",".join(f"{k}={v}" for k, v in sorted(f.items()) if "field" not in k)
       + (",joint" if "short_target_field" in f else "") for m, mode, f in CASES]


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


def _reader_args(root, dataset="Synth"):
    return argparse.Namespace(path=str(root), dataset=dataset, sep="\t", include_item_features=1,
                              include_user_features=1, include_situation_features=1)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(port ContextSeqReader, JAX ContextSeqReader) of one synthetic corpus
    with user, item and situation features."""
    root = tmp_path_factory.mktemp("context_seq")
    synthetic.make_ctr_dataset(str(root / "Synth"), n_users=60, n_items=50, n_per_user=12)
    args = _reader_args(root)
    return ContextSeqReader(args), JaxContextSeqReader(args)


@pytest.fixture(scope="module")
def topk_corpora(tmp_path_factory):
    """The same readers of a top-k corpus (positive rows, 99 sampled
    negatives a dev / test row)."""
    root = tmp_path_factory.mktemp("context_seq_topk")
    synthetic.make_ctr_dataset(str(root / "Synth"), n_users=60, n_items=120, n_per_user=12,
                               expose_bias=0.6, topk=True)
    args = _reader_args(root)
    return ContextSeqReader(args), JaxContextSeqReader(args)


def model_args(name, mode, **flags):
    """The CLI's defaults of `<name><mode>` with `flags` over them."""
    parser = registry.get_model(name, mode).parse_model_args(argparse.ArgumentParser())
    args = parser.parse_args([])
    args.__dict__.update({"emb_size": EMB, "history_max": H, "loss_n": "BCE" if mode == "CTR" else "BPR",
                          **flags})
    return args


# ------------------------------------------------------- reader, batchers
def test_reader_equals_jax(corpora):
    """Positions, the history CSR of items and times, the per-step
    situation CSR, and the fixed-shape history and historical-situation
    arrays of every split."""
    corpus, jcorpus = corpora
    np.testing.assert_array_equal(corpus.user_his.flat, jcorpus.user_his.flat)
    np.testing.assert_array_equal(corpus.user_his.offsets, jcorpus.user_his.offsets)
    np.testing.assert_array_equal(corpus.user_his_situ.flat, jcorpus.user_his_situ.flat)
    np.testing.assert_array_equal(corpus.user_his_situ.offsets, jcorpus.user_his_situ.offsets)
    assert corpus.user_his_situ.flat.shape[1] == 1 and corpus.situation_feature_names == ["c_hour_c"]
    for key in ("train", "dev", "test"):
        df, jdf = corpus.data_df[key], jcorpus.data_df[key]
        np.testing.assert_array_equal(df["position"].to_numpy(), jdf["position"].to_numpy())
        for got, want in zip(corpus.history_arrays(df, H), jcorpus.history_arrays(jdf, H)):
            np.testing.assert_array_equal(got, want)
        situ = corpus.history_situ_arrays(df, H)
        assert situ.shape == (len(df), H, 1) and situ.any()
        np.testing.assert_array_equal(situ, jcorpus.history_situ_arrays(jdf, H))


@pytest.mark.parametrize("mode", ["CTR", "TopK"])
@pytest.mark.parametrize("add_hist", [0, 1])
def test_batchers_equal_jax(corpora, topk_corpora, mode, add_hist):
    """Every array of the train / dev / test batchers (the CTR batcher keeps
    the same position > 0 rows) and the evaluation feeds of a few rows:
    ids, lengths, history, situation and historical situation."""
    corpus, jcorpus = corpora if mode == "CTR" else topk_corpora
    args = model_args("DIN", mode, add_historical_situations=add_hist, num_neg=1)
    model = registry.get_model("DIN", mode).from_args(args, corpus)
    jmodel = jregistry.get_model("DIN", mode).from_args(args, jcorpus)
    for phase in ("train", "dev", "test"):
        b = get_batcher(model.batcher)(corpus, model, phase, args)
        jb = jget_batcher(jmodel.batcher)(jcorpus, jmodel, phase, args)
        assert b.n == jb.n and b.arrays.keys() == jb.arrays.keys()
        assert ("history_situ" in b.arrays) == bool(add_hist)
        if mode == "CTR":
            assert (b._df["position"] > 0).all() and len(b._df) == (corpus.data_df[phase]["position"] > 0).sum()
        for k, v in jb.arrays.items():
            assert b.arrays[k].dtype == v.dtype, k
            np.testing.assert_array_equal(b.arrays[k], v, err_msg=k)
        if phase == "train":
            continue
        idx = np.arange(min(5, b.n))
        feed = b.eval_feed(b.device_arrays("cpu"), torch.from_numpy(idx))
        jfeed = jb.eval_feed(jb.device_arrays(), jnp.asarray(idx))
        assert {k for k in feed if k != "batch_size"} == {k for k in jfeed if k != "batch_size"}
        for k, v in jfeed.items():
            if k != "batch_size":
                np.testing.assert_array_equal(np.asarray(feed[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("n_items", [3, 50])
def test_negative_history_in_range_and_rejected(n_items):
    """DIEN's negative history: uniform ids in [1, n_items) from the step's
    generator, each the first of its 4 + 1 draws that differs from the
    positive at its slot, and equal to it only where all of them did."""
    rng = np.random.default_rng(0)
    hist = torch.from_numpy(rng.integers(0, n_items, size=(64, H)))
    batcher = types.SimpleNamespace(model=types.SimpleNamespace(alpha_aux=0.1),
                                    corpus=types.SimpleNamespace(n_items=n_items))
    feed = _maybe_neg_history(batcher, {"history_items": hist}, torch.Generator().manual_seed(5))
    neg = feed["history_neg_items"]
    assert neg.shape == hist.shape and neg.dtype == hist.dtype
    assert int(neg.min()) >= 1 and int(neg.max()) < n_items
    draws = torch.randint(1, n_items, (5,) + tuple(hist.shape), generator=torch.Generator().manual_seed(5),
                          dtype=hist.dtype)
    ok = draws != hist[None]
    first = torch.where(ok.any(0), ok.to(torch.int8).argmax(0), torch.full_like(hist, 4))
    np.testing.assert_array_equal(neg.numpy(), draws.gather(0, first[None])[0].numpy())
    same = neg == hist
    assert torch.equal(same, ~ok.any(0))
    if n_items == 3:
        assert 0 < int(same.sum()) < same.numel() // 10    # 4 rounds leave a few at 1/2^5
    off = _maybe_neg_history(types.SimpleNamespace(model=types.SimpleNamespace(alpha_aux=0.0),
                                                   corpus=batcher.corpus), {"history_items": hist}, None)
    assert "history_neg_items" not in off


# --------------------------------------------------------------- layers
def _redraw(tree, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32), tree)


def _redraw_stats(stats, seed):
    """Running means around 0, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(stats)
    out = {k: (rng.normal(size=v.shape) * 0.2 if k[-1] == "mean"
               else rng.uniform(0.5, 1.5, size=v.shape)).astype(np.float32) for k, v in flat.items()}
    return flax.traverse_util.unflatten_dict(out)


def _jax_run(fn, *args):
    """`fn(*args)` as one jitted program compiled without LLVM's costly
    passes: the programs are tiny and compile time dominates."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jax.device_get(compiled(*args))


def test_dice_train_eval_and_running_stats_equal_flax():
    """A training forward (batch statistics, which move the running ones at
    momentum 0.9), then an evaluation forward on the moved statistics."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(16, 3, 5)) * 2 + 1).astype(np.float32)
    x2 = rng.normal(size=(4, 5)).astype(np.float32)
    jdice = jlayers.Dice()
    variables = jax.device_get(jdice.init(jax.random.key(0), jnp.asarray(x)))
    params = {"alpha": rng.normal(size=5).astype(np.float32),
              "bn": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                     "bias": rng.normal(size=5).astype(np.float32)}}
    want, new = jdice.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                            training=True, mutable=["batch_stats"])
    want_eval = jdice.apply({"params": params, "batch_stats": new["batch_stats"]}, jnp.asarray(x2))
    dice = Dice(5)
    with torch.no_grad():
        dice.alpha.copy_(torch.from_numpy(params["alpha"]))
        dice.bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
        dice.bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))
        got = dice(torch.from_numpy(x), training=True)
        got_eval = dice(torch.from_numpy(x2))
    assert dice.bn.eps == 1e-8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(dice.bn.running_mean.numpy(), stats["mean"], **TOL)
    np.testing.assert_allclose(dice.bn.running_var.numpy(), stats["var"], **TOL)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), **TOL)


@pytest.mark.parametrize("gru_type", ["AGRU", "AUGRU", "AIGRU"])
def test_attentional_gru_equals_flax(gru_type, monkeypatch):
    """The final states and the input gradient at lengths 0, 1, T and in
    between: the port's rows of C = 3 candidates sharing one input
    sequence against the JAX layer on the same rows flattened to [B * C]."""
    rng = np.random.default_rng(2)
    Bn, C, T, D, Hs = 6, 3, 7, 5, 4
    x = rng.normal(size=(Bn, T, D)).astype(np.float32)
    att = rng.random(size=(Bn, C, T)).astype(np.float32)
    lengths = np.array([0, 1, T, 3, T - 1, 2], dtype=np.int32)
    flat_len = np.repeat(lengths, C)
    jgru = jlayers.AttentionalGRU(Hs, gru_type=gru_type)
    params = _redraw(jax.eval_shape(jgru.init, jax.random.key(0), np.repeat(x, C, 0), att.reshape(-1, T),
                                    flat_len)["params"], 3, 0.5)

    def jfn(p, a, s):
        def run(a2):
            return jgru.apply({"params": p}, jnp.repeat(a2, C, axis=0), s.reshape(-1, T), flat_len)
        return run(a), jax.grad(lambda a2: (run(a2) ** 2).sum())(a)

    want, want_g = _jax_run(jfn, params, x, att)
    gru = AttentionalGRU(D, Hs, gru_type)
    gru.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    got = gru(xt, torch.from_numpy(att), torch.from_numpy(lengths).long())
    (got ** 2).sum().backward()
    assert got.shape == (Bn, C, Hs)
    np.testing.assert_allclose(got.detach().numpy().reshape(-1, Hs), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, **TOL)
    assert not got[0].abs().any()                           # length 0: the zero state
    for max_rows in (Bn * C, Bn * C - 1):                   # AIGRU's two evaluation lanes
        monkeypatch.setattr(AttentionalGRU, "CUDNN_MAX_ROWS", max_rows)
        with torch.no_grad():
            got = gru(torch.from_numpy(x), torch.from_numpy(att), torch.from_numpy(lengths).long())
        np.testing.assert_allclose(got.numpy().reshape(-1, Hs), want, **TOL)
    assert all("bias" in k for k in ("bias_x", "bias_h"))


@pytest.mark.parametrize("heads,use_qkvo", [(1, 1), (2, 1), (1, 0), (2, 0)])
def test_multi_head_target_attention_equals_flax(heads, use_qkvo):
    """[B, C, D] targets over [B, H, D] histories under a [B, C, H] mask
    with fully masked rows (which attend uniformly in both)."""
    rng = np.random.default_rng(4)
    t = rng.normal(size=(5, 3, 8)).astype(np.float32)
    s = rng.normal(size=(5, 6, 8)).astype(np.float32)
    mask = rng.random((5, 3, 6)) < 0.6
    mask[0, 1] = False
    mask[3] = False
    jatt = jlayers.MultiHeadTargetAttention(input_dim=8, attention_dim=6 if heads == 2 else 4,
                                            num_heads=heads, use_qkvo=bool(use_qkvo))
    shapes = jax.eval_shape(lambda a, b, m: jatt.init(jax.random.key(0), a, b, m), t, s, mask)
    params = _redraw(shapes.get("params", {}), 5, 0.4)
    want = _jax_run(lambda p, a, b, m: jatt.apply({"params": p}, a, b, m), params, t, s, mask)
    att = MultiHeadTargetAttention(8, 6 if heads == 2 else 4, heads, use_qkvo=bool(use_qkvo))
    state = weights.from_flax_params({"short_attention_0": params}, "ETACTR") if params else {}
    att.load_state_dict({k[len("short_attention_0."):]: v for k, v in state.items()})
    with torch.no_grad():
        got = att(torch.from_numpy(t), torch.from_numpy(s), torch.from_numpy(mask))
    assert got.shape == (5, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -------------------------------------------------------- ETA, SDIM math
def _lsh_pair(cls, jcls, **fields):
    """The port's and the JAX package's retrieval methods on bare objects
    with the model fields they read."""
    class Port(cls):
        def __init__(self):
            self.__dict__.update(fields)

    class Jax(jcls):
        pass

    j = Jax()
    j.__dict__.update(fields)
    return Port(), j


@pytest.mark.parametrize("ref_retrieval", [0, 1])
def test_eta_topk_retrieval_breaks_ties_as_lax_top_k(ref_retrieval):
    """Two hash bits, one hash, 20 history steps: the similarities take a
    handful of integer values, so most k-th places are ties; the retrieved
    rows (distinct vectors, so the indices in order) equal lax.top_k's."""
    rng = np.random.default_rng(6)
    Bn, C, Hn, D = 16, 4, 20, 8
    target = rng.normal(size=(Bn, C, D)).astype(np.float32)
    seq = rng.normal(size=(Bn, Hn, D)).astype(np.float32)
    mask = rng.random((Bn, Hn)) < 0.7
    rot = rng.normal(size=(D, 1, 2)).astype(np.float32)
    fields = dict(ref_retrieval=ref_retrieval, hash_bits=2, num_hashes=1, retrieval_k=5)
    port, jax_side = _lsh_pair(ETABase, JaxETABase, **fields)
    want_emb, want_mask = _jax_run(lambda r, t, s, m: jax_side.topk_retrieval(r, t, s, m), rot, target, seq, mask)
    got_emb, got_mask = port.topk_retrieval(*(torch.from_numpy(a) for a in (rot, target, seq, mask)))
    np.testing.assert_array_equal(got_emb.numpy(), want_emb)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    # ties decide: most rows have equal scores across the k-th place
    t_code, s_code = (np.maximum(np.sign(np.einsum("...ld,dnt->...lnt", v, rot)), 0) for v in (target, seq))
    if ref_retrieval:
        t_id, s_id = ((c * [1, 2]).sum(-1) for c in (t_code, s_code))
        sim = np.where(mask[:, None], -np.abs(t_id[:, :, None] - s_id[:, None]).sum(-1), -2)
    else:
        sim = np.where(mask[:, None], -(t_code[:, :, None] != s_code[:, None]).sum((-1, -2)), -3)
    ranked = -np.sort(-sim, axis=-1)
    assert (ranked[..., 4] == ranked[..., 5]).mean() > 0.5


def test_sdim_lsh_attention_equals_jax():
    rng = np.random.default_rng(7)
    target = rng.normal(size=(6, 3, 8)).astype(np.float32)
    seq = rng.normal(size=(6, 10, 8)).astype(np.float32)
    mask = rng.random((6, 10)) < 0.7
    rot = rng.normal(size=(8, 3, 2)).astype(np.float32)
    port, jax_side = _lsh_pair(SDIMBase, JaxSDIMBase, hash_bits=2, num_hashes=3)
    want = _jax_run(lambda r, t, s, m: jax_side.lsh_attention(r, t, s, m), rot, target, seq, mask)
    got = port.lsh_attention(*(torch.from_numpy(a) for a in (rot, target, seq, mask)))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------- the models
def _feed(corpus, mode, add_hist, alpha_aux, seed=0):
    """A numpy feed of B rows: ids in range, lengths 0, 1, H and between,
    the history, its situations, a negative history, labels."""
    rng = np.random.default_rng(seed)
    C = 1 if mode == "CTR" else C_TOPK
    lengths = rng.integers(1, H + 1, size=B)
    lengths[:3] = [0, 1, H]
    hist = rng.integers(1, corpus.n_items, size=(B, H)) * (np.arange(H)[None, :] < lengths[:, None])
    n_hour = corpus.feature_max["c_hour_c"]
    feed = {"user_id": rng.integers(1, corpus.n_users, size=B),
            "item_id": rng.integers(1, corpus.n_items, size=(B, C)),
            "situ_cat": rng.integers(0, n_hour, size=(B, 1)),
            "history_items": hist, "lengths": lengths}
    if add_hist:
        feed["history_situ"] = rng.integers(0, n_hour, size=(B, H, 1))
    if alpha_aux:
        feed["history_neg_items"] = rng.integers(1, corpus.n_items, size=(B, H))
    if mode == "CTR":
        feed["label"] = (rng.random(B) < 0.4).astype(np.float32)
    return feed


def _jfeed(feed):
    return {k: jnp.asarray(v) if v.dtype == np.float32 else jnp.asarray(v, jnp.int32)
            for k, v in feed.items()}


def _tfeed(feed):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v.astype(np.int64))
            for k, v in feed.items()}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request, corpora):
    """(registered name, flax variables with redrawn params and batch_stats,
    torch model with the same state, numpy feed, and what the JAX package
    computes: the evaluation forward, the training loss, its gradients and
    the moved batch_stats)."""
    name, mode, flags = request.param
    corpus, jcorpus = corpora
    args = model_args(name, mode, **flags)
    reg_name = name + mode
    jmodel = jregistry.get_model(name, mode).from_args(args, jcorpus)
    feed = _feed(corpus, mode, flags.get("add_historical_situations", 0), flags.get("alpha_aux", 0))
    jfeed = _jfeed(feed)
    shapes = jax.eval_shape(lambda f: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, f, training=True), jfeed)
    variables = {"params": _redraw(shapes["params"], 1, scale=0.5)}
    consts = {k: np.asarray(v) for k, v in jmodel.constants_factory().items()}
    rotations = {}
    for k in shapes["constants"]:
        if k.startswith("random_rotations"):      # the fixed draws of key(42)
            rotations[k] = np.asarray(jax.random.normal(jax.random.key(42), shapes["constants"][k].shape))
    variables["constants"] = {**consts, **rotations}
    assert variables["constants"].keys() == shapes["constants"].keys()
    if "batch_stats" in shapes:
        variables["batch_stats"] = _redraw_stats(shapes["batch_stats"], 2)
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    def jax_side(variables, jfeed):
        rest = {k: v for k, v in variables.items() if k != "params"}

        def jloss(p):
            out = jmodel.apply({"params": p, **rest}, jfeed, training=True, mutable=mutable)
            out, new = out if mutable else (out, {})
            return jmodel.loss(out, jfeed), (new, out)

        (jl, (new, tout)), grads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
        return jmodel.apply(variables, jfeed, training=False), jl, grads, new, tout

    want = _jax_run(jax_side, variables, jfeed)
    model = registry.get_model(name, mode).from_args(args, corpus)
    state = weights.from_flax_params(variables["params"], reg_name)
    if "batch_stats" in variables:
        state.update(weights.from_flax_params(variables["batch_stats"], reg_name))
    if rotations:
        own = weights.from_flax_params(rotations, reg_name)
        for k, v in own.items():   # the port's own seed-42 draws have the same shape
            assert model.state_dict()[k].shape == v.shape
        state.update(own)
    model.load_state_dict(state)
    return reg_name, variables, model, feed, want


def test_forward_equals_flax(pair):
    name, _, model, feed, (want, _, _, _, _) = pair
    with torch.no_grad():
        got = model(_tfeed(feed))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **TOL, err_msg=k)
    pred = np.asarray(want["prediction"])
    assert pred.shape == ((B,) if name.endswith("CTR") else (B, C_TOPK))
    assert np.ptp(pred) > 1e-3, "the scores vary"


def test_loss_gradients_and_batch_stats_equal_flax(pair):
    """The training forward (batch statistics in the BatchNorms and Dice,
    which move their running ones; DIEN's auxiliary loss on the feed's
    negative history), the loss and every gradient."""
    name, variables, model, feed, (_, jl, jgrads, new_vars, tout) = pair
    tfeed = _tfeed(feed)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad()
    out = model(tfeed, training=True, gen=torch.Generator().manual_seed(0))
    assert out.keys() == tout.keys()
    if "aux_loss" in tout:
        np.testing.assert_allclose(float(out["aux_loss"].detach()), float(tout["aux_loss"]), **TOL)
    loss = model.loss(out, tfeed)
    loss.backward()
    try:
        np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
        want_g = weights.from_flax_params(jgrads, name)
        got_g = {k: p.grad for k, p in model.named_parameters()}
        assert want_g.keys() == got_g.keys()
        assert max(float(g.abs().max()) for g in got_g.values() if g is not None) > 1e-3
        for k, g in got_g.items():
            g = torch.zeros_like(want_g[k]) if g is None else g
            np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), **TOL, err_msg=k)
        if "batch_stats" in variables:
            want_s = weights.from_flax_params(new_vars["batch_stats"], name)
            own = model.state_dict()
            assert want_s and all(not torch.equal(own[k], before[k]) for k in want_s)
            for k, v in want_s.items():
                np.testing.assert_allclose(own[k].numpy(), v.numpy(), **TOL, err_msg=k)
    finally:
        model.load_state_dict(before)


def test_params_round_trip_count_and_l2_exempt_set(pair):
    """The parameter count, the flax round trip of every collection (ETA's
    and SDIM's rotations through `constants`), and the weight-decay mask:
    the GRU's bias_x / bias_h exempt, Dice's alpha, DIEN's attentionW and
    CAN's item_embedding_induce decayed, as in the JAX package."""
    name, variables, model, _, _ = pair
    params = variables["params"]
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    state = model.state_dict()
    for collection in ("params", "batch_stats", "constants"):
        tree = variables.get(collection, {})
        if collection == "constants":
            tree = {k: v for k, v in tree.items() if k.startswith("random_rotations")}
        back = weights.to_flax_params(state, name, collection=collection)
        flat = flax.traverse_util.flatten_dict(tree)
        flat_back = flax.traverse_util.flatten_dict(back)
        assert flat.keys() == flat_back.keys(), collection
        for path, leaf in flat.items():
            np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))
    jmask = flax.traverse_util.flatten_dict(jbase._decay_mask(params))
    tmask = tbase._decay_mask(dict(model.named_parameters()))
    assert len(jmask) == len(tmask)
    for path, decayed in jmask.items():
        assert tmask[weights._torch_leaf(name, path)[0]] == decayed, path
    for k in ("attentionW", "item_embedding_induce.weight", "dnn_mlp_layers.dice_0.alpha"):
        if k in tmask:
            assert tmask[k]
    for k in ("evolving_gru.bias_x", "evolving_gru.bias_h"):
        if k in tmask:
            assert not tmask[k]


def test_lsh_rotations_are_the_seed_42_draws_and_persist(corpora):
    """The rotations are fixed whatever the run's seed: drawn at
    construction from a generator seeded 42, untouched by init_weights,
    and saved in the state_dict (so --load reproduces the metrics)."""
    corpus, _ = corpora
    args = model_args("ETA", "CTR", history_max=8, recent_k=3, hash_bits=3, num_hashes=2)
    a = registry.get_model("ETA", "CTR").from_args(args, corpus)
    b = registry.get_model("ETA", "CTR").from_args(args, corpus)
    a.init_weights(torch.Generator().manual_seed(1))
    b.init_weights(torch.Generator().manual_seed(2))
    assert "random_rotations_0" in a.state_dict()
    assert torch.equal(a.random_rotations_0, b.random_rotations_0)
    want = torch.randn((EMB, 2, 3), generator=torch.Generator().manual_seed(42))
    assert torch.equal(a.random_rotations_0, want)
    assert not torch.equal(a.fused_table.weight, b.fused_table.weight)


# ----------------------------------------------------------------- CLI
@pytest.mark.parametrize("name", ["DIN", "DIEN", "CAN", "ETA", "SDIM"])
@pytest.mark.parametrize("mode", ["CTR", "TopK"])
def test_every_model_flag_of_the_jax_package_is_kept(name, mode):
    """Each class is registered under the JAX package's name and takes all
    of its model flags, with the same defaults."""
    parse = lambda cls: vars(cls.parse_model_args(argparse.ArgumentParser()).parse_args([]))  # noqa: E731
    cls = registry.get_model(name, mode)
    assert cls.registered_name == name + mode
    want, got = parse(jregistry.get_model(name, mode)), parse(cls)
    assert want.keys() <= got.keys()
    assert {k: got[k] for k in want if k != "model_path"} == {k: v for k, v in want.items() if k != "model_path"}


LOG_EPOCH = re.compile(r"^Epoch 1\s+loss=([0-9.]+) \[[\d.]+ s\]\tdev=\((\w+@?\d*:[\d.]+,?)+\)", re.M)


def _cli(root, tmp_path, model, mode, dataset, *extra):
    log = tmp_path / f"{model}{mode}.log"
    argv = ["--model_name", model, "--model_mode", mode, "--emb_size", "8", "--history_max", "6",
            "--dataset", dataset, "--path", str(root), "--gpu", "", "--epoch", "1", "--batch_size", "128",
            "--include_item_features", "1", "--include_user_features", "1",
            "--include_situation_features", "1", "--save_final_results", "0",
            "--log_file", str(log), "--model_path", str(tmp_path / f"{model}{mode}.bin"), *extra]
    port_main.build_parser_and_run(argv)
    return log.read_text()


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    synthetic.make_ctr_dataset(str(root / "SynthCTR"), n_users=80, n_items=60, n_per_user=14)
    synthetic.make_ctr_dataset(str(root / "SynthTOPK"), n_users=80, n_items=150, n_per_user=14,
                               expose_bias=0.6, topk=True)
    return root


@pytest.mark.parametrize("model,mode,dataset,extra", [
    ("DIN", "TopK", "SynthTOPK", ["--att_layers", "[8]", "--dnn_layers", "[8]", "--metric", "NDCG,HR",
                                  "--topk", "5"]),
    ("DIEN", "CTR", "SynthCTR", ["--evolving_gru_type", "AIGRU", "--alpha_aux", "0.5", "--fcn_hidden_layers",
                                 "[8]", "--metric", "AUC,LOG_LOSS", "--loss_n", "BCE"]),
])
def test_cli_one_epoch_with_the_jax_log_grammar(cli_root, tmp_path, model, mode, dataset, extra):
    text = _cli(cli_root, tmp_path, model, mode, dataset, *extra)
    m = LOG_EPOCH.search(text)
    assert m and np.isfinite(float(m.group(1))), text[-2000:]
    for prefix in ("Test Before Training: (", "Dev  After Training: (", "Test After Training: ("):
        assert prefix in text
    assert f"{model}{mode}" in text and "#params:" in text


def test_check_logs_din_attention(corpora, caplog):
    """`BaseRunner.check` logs the DIN attention map (the JAX model sows it
    as `din_attention`): [B, C, H] of one dev batch, 0 past each length."""
    corpus, _ = corpora
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args = model_args("DIN", "CTR", att_layers="[6]", dnn_layers="[8]")
    args.__dict__.update({**ns.__dict__, "gpu": "", "random_seed": 0, "model_path": "",
                          "eval_batch_size": 16, "metric": "AUC"})
    model = registry.get_model("DIN", "CTR").from_args(args, corpus)
    runner = registry.get_runner(model.runner)(args)
    batcher = get_batcher(model.batcher)(corpus, model, "dev", args)
    state = runner.init_state(model, 0)
    with caplog.at_level(logging.INFO):
        runner.check(state, batcher, batcher.device_arrays(runner.device))
    assert re.search(rf"^din_attention +shape=16x1x{H} ", caplog.text, re.M), caplog.text
    assert model.intermediates is None


@pytest.mark.parametrize("mode", ["CTR", "TopK"])
def test_lazy_emb_adam_as_the_jax_package(corpora, topk_corpora, mode, caplog):
    """The lazy lane as in the JAX package: a CTR mode declares no lazy
    tables and trains dense; a TopK mode has GeneralModel's specs, which
    its parameters lack, and its first step raises the JAX package's error
    before any update."""
    corpus, _ = corpora if mode == "CTR" else topk_corpora
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args = model_args("DIN", mode, att_layers="[6]", dnn_layers="[8]", num_neg=1)
    args.__dict__.update({**ns.__dict__, "gpu": "", "random_seed": 0, "model_path": "", "batch_size": 32,
                          "lazy_emb_adam": 1})
    model = registry.get_model("DIN", mode).from_args(args, corpus)
    with caplog.at_level(logging.WARNING):
        runner = registry.get_runner(model.runner)(args)
        state = runner.init_state(model, 0)
    batcher = get_batcher(model.batcher)(corpus, model, "train", args)
    arrays = batcher.device_arrays(runner.device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    if mode == "CTR":
        assert "DINCTR declares no lazy tables; dense optimizer" in caplog.text
        assert np.isfinite(runner.fit(state, batcher, arrays, 1, max_steps=2)) and state.step == 2
        assert not torch.equal(model.fused_table.weight, before["fused_table.weight"])
        return
    with pytest.raises(ValueError, match="lazy_table_specs matched no param/feed keys"):
        runner.fit(state, batcher, arrays, 1, max_steps=2)
    assert state.step == 0 and all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_din_ctr_learns_above_the_jax_bar(tmp_path_factory):
    """tests/test_e2e_context_seq.py's DINCTR run (SynthCTR at 20 rows a
    user, exposure bias 0.7, emb 16, 8 epochs, lr 1e-2) through the port's
    runner: test AUC above 0.65."""
    root = tmp_path_factory.mktemp("lift")
    synthetic.make_ctr_dataset(str(root / "SynthCTR"), n_per_user=20, expose_bias=0.7)
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args = model_args("DIN", "CTR", att_layers="[16]", dnn_layers="[32]", history_max=10, emb_size=16)
    args.__dict__.update({**ns.__dict__, **_reader_args(root, "SynthCTR").__dict__, **dict(
        gpu="", random_seed=3, check_epoch=0, early_stop=20, epoch=8, lr=1e-2, l2=0.0, batch_size=256,
        eval_batch_size=256, topk="5", metric="AUC,LOG_LOSS", model_path="")})
    model_cls = registry.get_model("DIN", "CTR")
    corpus = ContextSeqReader(args)
    model = model_cls.from_args(args, corpus)
    runner = registry.get_runner(model_cls.runner)(args)
    batchers = {p: get_batcher(model_cls.batcher)(corpus, model, p, args) for p in ("train", "dev", "test")}
    arrays = {p: b.device_arrays(runner.device) for p, b in batchers.items()}
    state = runner.train(batchers, runner.init_state(model, args.random_seed), arrays)
    after = runner.evaluate(state, batchers["test"], arrays["test"], "test", [], runner.metrics)
    assert np.isfinite(after["AUC"]) and after["AUC"] > 0.65, after
