"""The ten context models of the port (FM, WideDeep, DeepFM, AFM, DCN,
DCNv2, xDeepFM, AutoInt, SAM, FinalMLP), each in its CTR and TopK mode,
against the JAX package on the same inputs: the forward output (and
`reg_loss`), the training loss and every parameter's gradient, and the
BatchNorm running statistics after a training forward, with the flax
parameters and `batch_stats` carried by `weights.FLAX_TO_TORCH`; DCNv2's
four structure/mixed cases, xDeepFM's direct 0/1 and SAM's five interaction
types (each variant in one mode); `FeatureEmbeddingBank`, the
flax-faithful `BatchNorm`, `MLPBlock` and the attention's width and output
projection on their own; and the metric lift of the JAX package's
end-to-end test (tests/test_e2e_context.py:48-83) through the port's runner
on the CPU.

Small sizes: D = 8, a 120-user x 100-item synthetic corpus with user,
item (one float) and situation features. Weights are redrawn from numpy
at O(0.2), so a mismatch cannot hide under tiny init values. Dropout is 0
where outputs are compared (the port draws its masks from torch's
generator). Tolerance: 1e-5 absolute plus 1e-5 relative (f32 sums in two
libraries; the relative part covers the few gradients above 1).
"""
import argparse
import logging

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.readers import ContextReader as JaxContextReader
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.ops.feature_bank import FeatureEmbeddingBank as JaxBank
from rechorus_tpu.ops.layers import MLPBlock as JaxMLPBlock
from rechorus_tpu.ops.layers import MultiHeadAttention as JaxMHA
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.data.readers import ContextReader
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import BatchNorm, MLPBlock, MultiHeadAttention
from rechorus_tpu_torch.runners import base as tbase

TOL = dict(rtol=1e-5, atol=1e-5)
EMB, B, C_TOPK = 8, 24, 3
# (model, flags): the defaults of the flags not named are the CLI's
MODELS = {
    "FM": {},
    "WideDeep": dict(layers="[16,8]"),
    "DeepFM": dict(layers="[16]"),
    "AFM": dict(attention_size=6, reg_weight=0.3),
    "DCN": dict(layers="[16,8]", cross_layer_num=2, reg_weight=0.5),
    "DCNv2": dict(layers="[16]", cross_layer_num=2, mixed=0, structure="parallel", reg_weight=0.5),
    "xDeepFM": dict(layers="[16]", cin_layers="[4,6]", direct=0, reg_weight=0.2),
    "AutoInt": dict(layers="[16]", attention_size=6, num_heads=2, num_layers=2),
    "SAM": dict(interaction_type="SAM3A", aggregation="mean_pooling", num_layers=2, use_residual=1),
    "FinalMLP": dict(mlp1_hidden_units="[16]", mlp2_hidden_units="[8,8]", mlp1_batch_norm=1,
                     mlp2_batch_norm=1, fs_hidden_units="[8]", fs1_context="c_hour_c,i_quality_f",
                     fs2_context="i_category_c", num_heads=2),
}
# the variants of one model beyond its row above, each in one mode (the
# two modes share the forward up to the head, which every model's row
# above checks in both)
VARIANTS = [
    ("DCNv2", "TopK", dict(mixed=0, structure="stacked")),
    ("DCNv2", "CTR", dict(mixed=1, structure="parallel", low_rank=4, expert_num=2)),
    ("DCNv2", "TopK", dict(mixed=1, structure="stacked", low_rank=4, expert_num=3)),
    ("xDeepFM", "TopK", dict(direct=1)),
    ("SAM", "CTR", dict(interaction_type="SAM1", aggregation="weighted_pooling")),
    ("SAM", "TopK", dict(interaction_type="SAM2A")),
    ("SAM", "CTR", dict(interaction_type="SAM2E")),
    ("SAM", "TopK", dict(interaction_type="SAM3E", aggregation="concat", num_layers=1, use_residual=0)),
    ("FinalMLP", "CTR", dict(fs1_context="", fs2_context="", mlp1_batch_norm=0, mlp2_batch_norm=0)),
]
CASES = [(m, mode, MODELS[m]) for m in MODELS for mode in ("CTR", "TopK")] + \
        [(m, mode, {**MODELS[m], **v}) for m, mode, v in VARIANTS]
IDS = [f"{m}{mode}-" + ",".join(f"{k}={v}" for k, v in sorted(f.items()) if k not in MODELS[m]
                                 or MODELS[m][k] != v) for m, mode, f in CASES]


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
def corpora(tmp_path_factory):
    """(port ContextReader, JAX ContextReader) of one synthetic corpus with
    user, item and situation features."""
    root = tmp_path_factory.mktemp("context")
    synthetic.make_ctr_dataset(str(root / "Synth"), n_users=120, n_items=100, n_per_user=12)
    args = argparse.Namespace(path=str(root), dataset="Synth", sep="\t", include_item_features=1,
                              include_user_features=1, include_situation_features=1)
    return ContextReader(args), JaxContextReader(args)


def model_args(name, mode, **flags):
    """The CLI's defaults of `<name><mode>` with `flags` over them."""
    parser = registry.get_model(name, mode).parse_model_args(argparse.ArgumentParser())
    args = parser.parse_args([])
    args.__dict__.update({"emb_size": EMB, "loss_n": "BCE" if mode == "CTR" else "BPR", **flags})
    return args


def _feed(corpus, mode, seed=0):
    """A numpy feed of B rows: ids in range, the situation ids, labels."""
    rng = np.random.default_rng(seed)
    C = 1 if mode == "CTR" else C_TOPK
    feed = {"user_id": rng.integers(0, corpus.n_users, size=B),
            "item_id": rng.integers(0, corpus.n_items, size=(B, C)),
            "situ_cat": rng.integers(0, corpus.feature_max["c_hour_c"], size=(B, 1))}
    if mode == "CTR":
        feed["label"] = (rng.random(B) < 0.4).astype(np.float32)
    return feed


def _jfeed(feed):
    return {k: jnp.asarray(v) if v.dtype == np.float32 else jnp.asarray(v, jnp.int32)
            for k, v in feed.items()}


def _tfeed(feed):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v.astype(np.int64))
            for k, v in feed.items()}


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
    """`fn(*args)` as one jitted program (eager flax compiles its primitives
    one by one), compiled without LLVM's costly passes: the programs are
    tiny and compile time dominates."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jax.device_get(compiled(*args))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request, corpora):
    """(registered name, flax model, its variables with redrawn params and
    batch_stats, torch model with the same state, numpy feed, and what the
    JAX package computes from them: the evaluation forward, the training
    loss, the gradients and the moved batch_stats)."""
    name, mode, flags = request.param
    corpus, jcorpus = corpora
    args = model_args(name, mode, **flags)
    reg_name = registry.get_model(name, mode).registered_name
    jmodel = jregistry.get_model(name, mode).from_args(args, jcorpus)
    feed = _feed(corpus, mode)
    jfeed = _jfeed(feed)
    # the variables' shapes need no compile; every value is redrawn below
    shapes = jax.eval_shape(lambda f: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, f, training=False), jfeed)
    variables = {"params": _redraw(shapes["params"], 1)}
    if "constants" in shapes:  # the corpus's feature matrices
        variables["constants"] = {k: np.asarray(v) for k, v in jmodel.constants_factory().items()}
        assert variables["constants"].keys() == shapes["constants"].keys()
    if "batch_stats" in shapes:
        variables["batch_stats"] = _redraw_stats(shapes["batch_stats"], 2)
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    def jax_side(variables, jfeed):
        rest = {k: v for k, v in variables.items() if k != "params"}

        def jloss(p):
            out = jmodel.apply({"params": p, **rest}, jfeed, training=True, mutable=mutable)
            out, new = out if mutable else (out, {})
            return jmodel.loss(out, jfeed), new

        (jl, new), grads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
        return jmodel.apply(variables, jfeed, training=False), jl, grads, new

    want = _jax_run(jax_side, variables, jfeed)
    model = registry.get_model(name, mode).from_args(args, corpus)
    state = weights.from_flax_params(variables["params"], reg_name)
    if "batch_stats" in variables:
        state.update(weights.from_flax_params(variables["batch_stats"], reg_name))
    model.load_state_dict(state)
    return reg_name, variables, model, feed, want


def test_forward_equals_flax(pair):
    name, _, model, feed, (want, _, _, _) = pair
    with torch.no_grad():
        got = model(_tfeed(feed))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **TOL, err_msg=k)
    pred = np.asarray(want["prediction"])
    assert pred.shape == ((B,) if name.endswith("CTR") else (B, C_TOPK))
    assert np.ptp(pred) > 1e-3, "the scores vary"


def test_loss_gradients_and_batch_stats_equal_flax(pair):
    """The training forward (batch statistics in the BatchNorms, which move
    their running ones), the loss with its reg term and every gradient."""
    name, variables, model, feed, (_, jl, jgrads, new_vars) = pair
    tfeed = _tfeed(feed)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad()
    loss = model.loss(model(tfeed, training=True, gen=torch.Generator().manual_seed(0)), tfeed)
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
    name, variables, model, _, _ = pair
    params = variables["params"]
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    state = model.state_dict()
    for collection in ("params", "batch_stats"):
        if collection not in variables:
            assert not any(k.endswith("running_mean") for k in state)
            continue
        back = weights.to_flax_params(state, name, collection=collection)
        flat = flax.traverse_util.flatten_dict(variables[collection])
        flat_back = flax.traverse_util.flatten_dict(back)
        assert flat.keys() == flat_back.keys(), collection
        for path, leaf in flat.items():
            np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))
    jmask = flax.traverse_util.flatten_dict(jbase._decay_mask(params))
    tmask = tbase._decay_mask(dict(model.named_parameters()))
    assert len(jmask) == len(tmask)
    for path, decayed in jmask.items():
        assert tmask[weights._torch_leaf(name, path)[0]] == decayed, path
    # the corpus's feature matrices are buffers outside the state_dict
    assert {"item_cat", "item_float", "user_cat"} <= set(dict(model.named_buffers()))
    assert not any(k in state for k in ("item_cat", "item_float", "user_cat", "user_float"))


@pytest.mark.parametrize("mode,loss_n", [("CTR", "MSE"), ("TopK", "BCE")])
def test_the_other_losses_equal_jax(corpora, mode, loss_n):
    """CTR's MSE and the TopK modes' multi-negative BCE, on FM."""
    corpus, jcorpus = corpora
    args = model_args("FM", mode, loss_n=loss_n)
    jmodel = jregistry.get_model("FM", mode).from_args(args, jcorpus)
    feed = _feed(corpus, mode, seed=3)
    shapes = jax.eval_shape(lambda f: jmodel.init(jax.random.key(0), f), _jfeed(feed))
    variables = {"params": _redraw(shapes["params"], 4, scale=0.4),
                 "constants": {k: np.asarray(v) for k, v in jmodel.constants_factory().items()}}
    model = registry.get_model("FM", mode).from_args(args, corpus)
    model.load_state_dict(weights.from_flax_params(variables["params"], "FM" + mode))
    want = _jax_run(lambda v, f: jmodel.loss(jmodel.apply(v, f), f), variables, _jfeed(feed))
    with torch.no_grad():
        got = model.loss(model(_tfeed(feed)), _tfeed(feed))
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ------------------------------------------------------------- the bank
@pytest.mark.parametrize("kinds,include_linear", [
    (("float", "cat", "float", "cat", "cat"), True),
    (("cat", "float", "cat"), False),
    (("cat", "cat"), True),
])
def test_feature_bank_equals_jax(kinds, include_linear):
    """The stacked embeddings in canonical order (floats interleaved) and
    the linear terms, weights carried by the context models' bank mapping."""
    rng = np.random.default_rng(5)
    vocab, n_cat = 40, kinds.count("cat")
    cat_ids = rng.integers(0, vocab, size=(6, 4, n_cat))
    floats = rng.normal(size=(6, 4, len(kinds) - n_cat)).astype(np.float32)
    jbank = JaxBank(total_vocab=vocab, kinds=kinds, vec_size=EMB, include_linear=include_linear)
    jargs = (jnp.asarray(cat_ids, jnp.int32), jnp.asarray(floats))
    params = _redraw(jax.eval_shape(jbank.init, jax.random.key(0), *jargs)["params"], 6, scale=1.0)
    want = _jax_run(lambda p, c, f: jbank.apply({"params": p}, c, f), params, *jargs)
    bank = FeatureEmbeddingBank(vocab, kinds, EMB, include_linear=include_linear)
    state = weights.from_flax_params({"bank": params}, "FMCTR")
    bank.load_state_dict({k[len("bank."):]: v for k, v in state.items()})
    with torch.no_grad():
        got = bank(torch.from_numpy(cat_ids), torch.from_numpy(floats))
    want = want if include_linear else (want,)
    got = got if include_linear else (got,)
    assert got[0].shape == (6, 4, len(kinds), EMB)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# ------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("shape", [(64, 5, 6), (48, 6)])
def test_batch_norm_steps_equal_flax(shape):
    """Three training forwards on fresh inputs (flax's fast variance, its
    biased running variance, momentum 0.9), then an evaluation forward on
    the running statistics, against flax's BatchNorm over the last axis."""
    rng = np.random.default_rng(7)
    d = shape[-1]
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    xs = [(rng.normal(size=shape) * (1 + k) + k).astype(np.float32) for k in range(4)]
    variables = jax.device_get(jbn.init(jax.random.key(0), jnp.asarray(xs[0]), use_running_average=True))
    params = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
              "bias": rng.normal(size=d).astype(np.float32)}
    stats = variables["batch_stats"]
    bn = BatchNorm(d)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
    for x in xs[:3]:
        want, new = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              use_running_average=False, mutable=["batch_stats"])
        stats = jax.device_get(new["batch_stats"])
        got = bn(torch.from_numpy(x), training=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-5)
    want = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[3]),
                     use_running_average=True)
    with torch.no_grad():
        got = bn(torch.from_numpy(xs[3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ------------------------------------------------- MLPBlock, attention
def _carry(module, params, stats=None):
    """Load flax `params` (and `batch_stats`) into a torch layer whose
    modules bear the flax names: kernel -> weight transposed, scale ->
    weight, mean / var -> running_mean / running_var."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    state = {}
    for tree in (params, stats or {}):
        for path, leaf in flax.traverse_util.flatten_dict(tree).items():
            leaf = torch.from_numpy(np.asarray(leaf))
            state[".".join(path[:-1] + (names[path[-1]],))] = leaf.T if path[-1] == "kernel" else leaf
    module.load_state_dict(state)


@pytest.mark.parametrize("norm", [None, "layer_norm", "batch_norm"])
def test_mlp_block_equals_flax(norm):
    """Two hidden layers with their own activations, each normalisation, a
    linear head; the evaluation forward and, with BatchNorm, the training
    one (batch statistics) against the JAX package's MLPBlock."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 3, 12)).astype(np.float32)
    jblock = JaxMLPBlock(hidden_units=(16, 8), hidden_activations=("Tanh", "GELU"), output_dim=3,
                         norm=norm)
    shapes = jax.eval_shape(lambda v: jblock.init(jax.random.key(0), v), x)
    params = _redraw(shapes["params"], 9, scale=0.4)
    stats = _redraw_stats(shapes["batch_stats"], 10) if norm == "batch_norm" else {}
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    block = MLPBlock(12, (16, 8), ("Tanh", "GELU"), output_dim=3, norm=norm)
    _carry(block, params, stats)
    want = _jax_run(lambda v, a: jblock.apply(v, a), variables, x)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if norm == "batch_norm":
        want = _jax_run(lambda v, a: jblock.apply(v, a, training=True, mutable=["batch_stats"])[0],
                        variables, x)
        with torch.no_grad():
            got = block(torch.from_numpy(x), training=True)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("out_proj", [False, True])
def test_attention_width_and_output_projection_equal_flax(out_proj):
    """MultiHeadAttention projecting d_model 12 to attention_d 8 (AutoInt's
    `attention_size`), with and without the output projection, under a
    mask that empties one row."""
    rng = np.random.default_rng(11)
    q, k = (rng.normal(size=(4, 5, 12)).astype(np.float32) for _ in range(2))
    mask = rng.random((4, 1, 5, 5)) < 0.7
    mask[0, :, 2] = False                                       # a fully masked row -> 0
    jmha = JaxMHA(12, 2, attention_d=8, out_proj=out_proj)
    shapes = jax.eval_shape(lambda a, b, m: jmha.init(jax.random.key(0), a, b, b, m), q, k, mask)
    params = _redraw(shapes["params"], 12, scale=0.4)
    mha = MultiHeadAttention(12, 2, attention_d=8, out_proj=out_proj)
    _carry(mha, params)
    want = _jax_run(lambda p, a, b, m: jmha.apply({"params": p}, a, b, b, m), params, q, k, mask)
    with torch.no_grad():
        got = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), torch.from_numpy(mask))
    assert got.shape == (4, 5, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if not out_proj:                                            # with it, the row is its bias
        assert not np.abs(got.numpy()[0, 2]).any()


# ------------------------------------------------------------- learning
def _lift(root, dataset, name, mode, metric, **flags):
    """(metric before, after) training through the port's runner on the CPU."""
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args = model_args(name, mode, **flags)
    args.__dict__.update({**ns.__dict__, **dict(
        path=root, dataset=dataset, sep="\t", include_item_features=1, include_user_features=1,
        include_situation_features=1, gpu="", random_seed=3, check_epoch=0, early_stop=100,
        batch_size=256, eval_batch_size=256, lr=1e-2, topk="5",
        metric="AUC,LOG_LOSS" if mode == "CTR" else "HR,NDCG", emb_size=16, model_path="",
        epoch=flags.get("epoch", 10))})
    model_cls = registry.get_model(name, mode)
    corpus = ContextReader(args)
    model = model_cls.from_args(args, corpus)
    runner = registry.get_runner(model_cls.runner)(args)
    batchers = {p: get_batcher(model_cls.batcher)(corpus, model, p, args) for p in ("train", "dev", "test")}
    arrays = {p: b.device_arrays(runner.device) for p, b in batchers.items()}
    state = runner.init_state(model, args.random_seed)
    before = runner.evaluate(state, batchers["test"], arrays["test"], "test", [5], runner.metrics)[metric]
    state = runner.train(batchers, state, arrays)
    after = runner.evaluate(state, batchers["test"], arrays["test"], "test", [5], runner.metrics)[metric]
    return before, after


@pytest.fixture(scope="module")
def lift_root(tmp_path_factory):
    """tests/test_e2e_context.py's CTR corpus, and a top-k one with the
    reference's ML_1MTOPK contract (99 sampled negatives per dev/test row)."""
    root = tmp_path_factory.mktemp("lift")
    synthetic.make_ctr_dataset(str(root / "SynthCTR"))
    synthetic.make_ctr_dataset(str(root / "SynthTOPK"), n_users=200, n_items=120, n_per_user=16,
                               expose_bias=0.6, topk=True)
    return str(root)


LEARN = {  # model: flags of the JAX package's e2e test, CTR lane (tests/test_e2e_context.py:58-78)
    "FM": dict(epoch=15),
    "WideDeep": dict(layers="[32]"),
    "DeepFM": dict(layers="[32]"),
    "AFM": dict(attention_size=16, reg_weight=0.1),
    "DCN": dict(layers="[32]", cross_layer_num=2, reg_weight=0.1),
    "DCNv2": dict(layers="[32]", cross_layer_num=2, mixed=1, structure="parallel", low_rank=8,
                  expert_num=2, reg_weight=0.1),
    "xDeepFM": dict(layers="[32]", cin_layers="[4,4]", direct=0, reg_weight=0.01),
    "AutoInt": dict(layers="[32]", attention_size=16, num_heads=2, num_layers=1, epoch=25),
    "SAM": dict(interaction_type="SAM2E", aggregation="concat", num_layers=1, use_residual=0),
    "FinalMLP": dict(mlp1_hidden_units="[32]", mlp2_hidden_units="[32]", fs_hidden_units="[16]",
                     fs1_context="", fs2_context="c_hour_c,i_category_c", num_heads=2),
}


@pytest.mark.parametrize("name", list(LEARN))
def test_ctr_mode_learns(lift_root, name):
    """Test AUC above 0.65 after training (the JAX e2e test's bar) and above
    the untrained model's."""
    before, after = _lift(lift_root, "SynthCTR", name, "CTR", "AUC", **LEARN[name])
    assert np.isfinite(after) and after > 0.65 and after > before, (name, before, after)


@pytest.mark.parametrize("name", list(LEARN))
def test_topk_mode_learns(lift_root, name):
    """Test HR@5 over the target and its 99 sampled negatives: well above
    the untrained model's (chance is 0.05)."""
    flags = {"epoch": 4, **LEARN[name]}
    before, after = _lift(lift_root, "SynthTOPK", name, "TopK", "HR@5", **flags)
    assert np.isfinite(after) and after > before + 0.05, (name, before, after)
