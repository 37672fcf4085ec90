"""The training slice of the port against the JAX package, piece by
piece: the BPR loss, the negative sampler, the batcher, the dense
optimizers, and -- with weights carried across -- the runner's evaluation
and top-k export. The port runs on the CPU (`--gpu ''`), where its kernel
wrappers use their plain versions; the JAX side runs as its own tests do
(CPU, Pallas in interpret mode). Inputs come from numpy seeds.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rechorus_tpu.data.batching import GeneralBatcher as JaxBatcher
from rechorus_tpu.data.readers import BaseReader as JaxReader
from rechorus_tpu.models.general.bprmf import BPRMF as FlaxBPRMF
from rechorus_tpu.ops import losses as jlosses
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import weights
from rechorus_tpu_torch.data.batching import GeneralBatcher
from rechorus_tpu_torch.data.readers import BaseReader
from rechorus_tpu_torch.models.general.bprmf import BPRMF
from rechorus_tpu_torch.ops import losses, sampling
from rechorus_tpu_torch.runners import base as tbase

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
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    ns.__dict__.update(path=DATA, dataset="Grocery_and_Gourmet_Food", sep="\t", emb_size=EMB,
                       num_neg=1, dropout=0.0, test_all=0, gpu="", random_seed=0, model_path="",
                       ckpt_format="flax")
    ns.__dict__.update(kw)
    return ns


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("n_neg", [1, 4])
def test_bpr_loss_value_and_gradient(n_neg):
    """1e-6: f32 exp/log of O(1) values in two libraries."""
    pred = np.random.default_rng(n_neg).normal(size=(33, 1 + n_neg)).astype(np.float32) * 3
    want, want_g = jax.value_and_grad(jlosses.bpr_multi_neg)(jnp.asarray(pred))
    t = torch.from_numpy(pred).requires_grad_(True)
    got = losses.bpr_multi_neg(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)


# -------------------------------------------------------------- sampling
def test_sample_negatives_range_and_rejection():
    """11 items of which each user clicked 5: rejection matters (a blind
    draw collides with p = 5/11; after 31 draws with p = 2e-11)."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    clicked = np.stack([rng.permutation(np.arange(1, 12))[:5] for _ in range(40)])
    clicked = torch.from_numpy(np.concatenate([clicked, np.zeros((40, 2), np.int64)], 1))
    users = torch.from_numpy(rng.integers(0, 40, size=512))
    neg = sampling.sample_negatives(gen, users, clicked, 3, 12, rounds=30)
    assert neg.shape == (512, 3) and neg.dtype == torch.int64
    assert int(neg.min()) >= 1 and int(neg.max()) < 12
    assert not (neg[:, :, None] == clicked[users][:, None, :]).any()
    assert len(torch.unique(neg)) > 5


def test_first_accepted_takes_first_ok_and_falls_back_to_last():
    cand = torch.tensor([[10, 20, 30], [11, 21, 31], [12, 22, 32]])
    bad = torch.tensor([[True, False, True], [False, False, True], [False, True, True]])
    # column 0: first accepted is round 1; column 1: round 0; column 2: all collide -> last
    assert sampling.first_accepted(cand, bad).tolist() == [11, 20, 32]


def test_candidate_permutation_restores():
    gen = torch.Generator().manual_seed(3)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(17, 6)).astype(np.float32))
    idx, inv = sampling.candidate_permutation(gen, x.shape, "cpu")
    assert sorted(idx[0].tolist()) == list(range(6)) and not torch.equal(idx[0], idx[1])
    assert torch.equal(sampling.restore_predictions(x.gather(-1, idx), inv), x)


# --------------------------------------------------------------- batcher
@pytest.fixture(scope="module")
def corpora():
    return BaseReader(_args()), JaxReader(_args())


@pytest.mark.parametrize("test_all", [0, 1])
def test_batcher_arrays_and_feeds_equal_jax(corpora, test_all):
    corpus, jcorpus = corpora
    model = argparse.Namespace(num_neg=2, test_all=test_all)
    rng = np.random.default_rng(test_all)
    for phase in ("train", "dev", "test"):
        b, jb = (GeneralBatcher(corpus, model, phase, _args()),
                 JaxBatcher(jcorpus, model, phase, _args()))
        assert len(b) == len(jb) and b.arrays.keys() == jb.arrays.keys()
        for k in b.arrays:
            np.testing.assert_array_equal(b.arrays[k], jb.arrays[k], err_msg=f"{phase}/{k}")
        arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
        idx = rng.integers(0, len(b), size=64)
        if phase == "train":                 # negatives injected: the feed is deterministic
            neg = rng.integers(1, corpus.n_items, size=(len(b), 2))
            arrays["_ep_neg_items"] = torch.from_numpy(neg)
            jarrays["_ep_neg_items"] = jnp.asarray(neg, jnp.int32)
            feed = b.train_feed(arrays, torch.from_numpy(idx), None)
            jfeed = jb.train_feed(jarrays, jnp.asarray(idx), None)
        else:
            feed = b.eval_feed(arrays, torch.from_numpy(idx))
            jfeed = jb.eval_feed(jarrays, jnp.asarray(idx))
        assert feed.keys() == jfeed.keys()
        for k in feed:
            np.testing.assert_array_equal(np.asarray(feed[k]), np.asarray(jfeed[k]),
                                          err_msg=f"{phase}/{k}")
        if phase != "train" and test_all:    # the catalog candidates are a view, not a copy
            assert feed["item_id"].stride(0) == 0


# ------------------------------------------------------------ optimizers
def test_decay_mask_names():
    params = {"i_embeddings.weight": 0, "item_bias.weight": 0, "lin.bias": 0, "lin.kernel": 0}
    assert tbase._decay_mask(params) == {"i_embeddings.weight": True, "item_bias.weight": False,
                                         "lin.bias": False, "lin.kernel": True}
    jmask = jbase._decay_mask({"i_embeddings": {"embedding": 0}, "item_bias": {"embedding": 0},
                               "lin": {"bias": 0, "kernel": 0}})
    assert jmask == {"i_embeddings": {"embedding": True}, "item_bias": {"embedding": False},
                     "lin": {"bias": False, "kernel": True}}


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name,lr,l2", [("Adam", 1e-3, 1e-6), ("Adam", 1e-2, 1e-2),
                                        ("SGD", 1e-1, 1e-3), ("AdamW", 1e-2, 1e-2),
                                        ("Adagrad", 1e-2, 1e-3), ("Adadelta", 1.0, 1e-3)])
def test_dense_optimizer_equals_optax(name, lr, l2, steps):
    """Same parameters and gradients on both sides; 1e-6 absolute on
    values of O(0.1): the two differ by f32 rounding in a few operations."""
    rng = np.random.default_rng(steps)
    shapes = {("emb", "embedding"): (30, 8), ("lin", "kernel"): (8, 4), ("lin", "bias"): (4,)}
    flat = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.05 for k, s in shapes.items()}
             for _ in range(steps)]
    nest = lambda d: {"emb": {"embedding": d[("emb", "embedding")]},                     # noqa: E731
                      "lin": {"kernel": d[("lin", "kernel")], "bias": d[("lin", "bias")]}}
    jparams = jax.tree.map(jnp.asarray, nest(flat))
    tx = jbase.build_optimizer(name, lr, l2)
    jstate = tx.init(jparams)
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, nest(g)), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

    params = {".".join(k): torch.from_numpy(v.copy()) for k, v in flat.items()}
    opt = tbase.build_optimizer(name, lr, l2)
    state = opt.init(params)
    for g in grads:
        opt.update(params, {".".join(k): torch.from_numpy(v) for k, v in g.items()}, state)
    assert state.count == steps
    want = {".".join(k): v for k, v in
            {("emb", "embedding"): jparams["emb"]["embedding"], ("lin", "kernel"): jparams["lin"]["kernel"],
             ("lin", "bias"): jparams["lin"]["bias"]}.items()}
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=f"{name}/{k}")


def test_adam_continues_from_carried_moments():
    """Two optax steps, then the moments cross through
    weights.from_flax_opt_state and both sides take three more: 1e-6."""
    rng = np.random.default_rng(7)
    tree = lambda a, b: {"u_embeddings": {"embedding": a}, "i_embeddings": {"embedding": b}}  # noqa: E731
    draw = lambda s: tree(jnp.asarray(rng.normal(size=(20, 8)).astype(np.float32) * s),       # noqa: E731
                          jnp.asarray(rng.normal(size=(30, 8)).astype(np.float32) * s))
    jparams, grads = draw(0.1), [draw(0.05) for _ in range(5)]
    tx = jbase.build_optimizer("Adam", 1e-3, 1e-6)
    jstate = tx.init(jparams)
    step = lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p))  # noqa: E731
    for g in grads[:2]:
        jparams, jstate = step(jparams, jstate, g)
    adam = [s for s in jax.tree.leaves(jstate, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    count, mu, nu = weights.from_flax_opt_state(adam.count, jax.device_get(adam.mu),
                                                jax.device_get(adam.nu))
    assert count == 2
    params = weights.from_flax_params(jax.device_get(jparams))
    opt = tbase.build_optimizer("Adam", 1e-3, 1e-6)
    state = tbase.DenseOptState(count=count, slots={"mu": mu, "nu": nu})
    for g in grads[2:]:
        jparams, jstate = step(jparams, jstate, g)
        opt.update(params, weights.from_flax_params(jax.device_get(g)), state)
    back = weights.to_flax_params(params)
    for name in ("u_embeddings", "i_embeddings"):
        np.testing.assert_allclose(back[name]["embedding"], np.asarray(jparams[name]["embedding"]),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------ the slice as a whole
@pytest.fixture(scope="module")
def carried(corpora):
    """JAX runner state and the port's, with the same (flax-drawn) weights."""
    corpus, jcorpus = corpora
    out = {}
    for test_all in (0, 1):
        ns = _args(test_all=test_all)
        jrunner = jbase.BaseRunner(ns)
        jmodel = FlaxBPRMF.from_args(ns, jcorpus)
        jb = {p: JaxBatcher(jcorpus, jmodel, p, ns) for p in ("train", "dev", "test")}
        jarr = {p: jrunner.place_arrays(b.device_arrays()) for p, b in jb.items()}
        jstate = jrunner.init_state(jmodel, jb["train"], 0)
        # integer-valued weights (|w| < 16, D = 16): every product and sum is
        # exact in f32 in any order, so both sides hold the SAME scores
        jstate = jstate.replace(params=jax.tree.map(lambda x: jnp.round(x * 300.0), jstate.params))
        runner = tbase.BaseRunner(ns)
        model = BPRMF.from_args(ns, corpus)
        tb = {p: GeneralBatcher(corpus, model, p, ns) for p in ("train", "dev", "test")}
        tarr = {p: b.device_arrays(runner.device) for p, b in tb.items()}
        state = runner.init_state(model, 0)
        model.load_state_dict(weights.from_flax_params(jax.device_get(jstate.params)))
        out[test_all] = (jrunner, jmodel, jb, jarr, jstate, runner, tb, tarr, state)
    return out


@pytest.mark.parametrize("test_all", [0, 1])
@pytest.mark.parametrize("phase", ["dev", "test"])
def test_evaluate_equals_jax_runner(carried, test_all, phase):
    """Ranks are integer counts of `>=` over scores that are exact on both
    sides (integer-valued weights), ties included: ranks and metrics must
    be equal, not close."""
    jrunner, jmodel, jb, jarr, jstate, runner, tb, tarr, state = carried[test_all]
    want_r = jrunner.predict_ranks(jstate, jmodel, jb[phase], jarr[phase], phase)
    got_r = runner.predict_ranks(state, tb[phase], tarr[phase], phase)
    assert int((want_r != got_r).sum()) == 0
    want = jrunner.evaluate(jstate, jmodel, jb[phase], jarr[phase], phase, [5, 10, 20, 50], ["HR", "NDCG"])
    got = runner.evaluate(state, tb[phase], tarr[phase], phase, [5, 10, 20, 50], ["HR", "NDCG"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k


@pytest.mark.parametrize("test_all", [0, 1])
def test_predict_topk_equals_jax_runner(carried, test_all):
    """Values equal (exact scores); ids where a value is distinct from its
    neighbours (torch.topk promises no order among ties)."""
    jrunner, jmodel, jb, jarr, jstate, runner, tb, tarr, state = carried[test_all]
    want_i, want_v = jrunner.predict_topk(jstate, jmodel, jb["test"], jarr["test"], "test", k=100)
    got_i, got_v = runner.predict_topk(state, tb["test"], tarr["test"], "test", k=100)
    assert got_i.shape == want_i.shape == (len(tb["test"]), 100) and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_v, want_v)
    gaps = np.abs(np.diff(want_v, axis=1))
    distinct = np.concatenate([gaps > 0, np.ones((len(gaps), 1), bool)], 1) & \
        np.concatenate([np.ones((len(gaps), 1), bool), gaps > 0], 1)
    distinct[:, -1] = False        # the last value may tie with the first one left out
    assert distinct.mean() > 0.1
    np.testing.assert_array_equal(got_i[distinct], want_i[distinct])
