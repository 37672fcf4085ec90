"""The five sequential models of the port (SASRec, GRU4Rec, NARM, Caser,
FPMC) against their flax twins in the JAX package, with the same weights
carried across (`weights.from_flax_params`): prediction on sampled
candidates, the catalog protocol's `u_v` (and FPMC's item table),
`#params`, the exact flax -> torch -> flax round trip, the L2-exempt
parameters, dropout, and the GRU block and initialisers on their own.

Small sizes: D = 16, H = 8 history slots, 2 transformer layers of 2
heads. Weights are redrawn from numpy at O(0.3), so activations are O(1)
and a mismatch cannot hide under the N(0, 0.01) init's tiny values.
Tolerance 1e-5 absolute: f32 products and sums of O(1) values in two
libraries (and flax's E[x^2] - E[x]^2 LayerNorm variance against torch's
two-pass one) differ by a few ulps.
"""
import argparse

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.batching import SequentialBatcher as JaxBatcher
from rechorus_tpu.data.readers import SeqReader as JaxReader
from rechorus_tpu.data.synthetic import make_topk_dataset
from rechorus_tpu.models.base import count_variables as jcount
from rechorus_tpu.ops import layers as jlayers
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.ops import layers
from rechorus_tpu_torch.runners import base as tbase

ATOL = 1e-5
EMB, HIS = 16, 8
MODELS = {
    "SASRec": dict(num_layers=2, num_heads=2),
    "GRU4Rec": dict(hidden_size=12),
    "NARM": dict(hidden_size=12, attention_size=5),
    "Caser": dict(num_horizon=4, num_vertical=3, L=3),
    "FPMC": dict(),
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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_models")
    make_topk_dataset(str(root / "Synth"), n_users=60, n_items=40, n_per_user=10)
    return JaxReader(argparse.Namespace(path=str(root), dataset="Synth", sep="\t"))


def _args(name, **kw):
    base = dict(num_neg=1, dropout=0.0, test_all=0, emb_size=EMB, history_max=HIS, host_shard_input=0)
    return argparse.Namespace(**{**base, **MODELS[name], **kw})


def _feeds(corpus, jmodel, args):
    """(jax feed, torch feed) of 32 dev rows: [target | 19 negatives]."""
    b = JaxBatcher(corpus, jmodel, "dev", args)
    jfeed = b.eval_feed(b.device_arrays(), jnp.arange(32))
    tfeed = {k: (torch.from_numpy(np.asarray(v).astype(np.int64)) if hasattr(v, "shape") else v)
             for k, v in jfeed.items()}
    return jfeed, tfeed


def _redraw(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.3), params)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request, corpus):
    """(name, flax model, flax params, torch model with the same weights,
    jax feed, torch feed)."""
    name = request.param
    args = _args(name)
    jmodel = jregistry.get_model(name).from_args(args, corpus)
    jfeed, tfeed = _feeds(corpus, jmodel, args)
    params = jmodel.init(jax.random.key(0), jfeed, training=False)["params"]
    params = jax.device_get(_redraw(params, 1))
    model = registry.get_model(name).from_args(args, corpus)
    model.load_state_dict(weights.from_flax_params(params, name), strict=True)
    return name, jmodel, params, model, jfeed, tfeed


def test_prediction_equals_flax(pair):
    name, jmodel, params, model, jfeed, tfeed = pair
    want = np.asarray(jmodel.apply({"params": params}, jfeed, training=False)["prediction"])
    with torch.no_grad():
        got = model(tfeed)["prediction"].numpy()
    assert got.shape == want.shape == (32, 20)
    assert np.abs(want).max() > 0.1, "O(1) scores, not the init's tiny ones"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_catalog_output_equals_flax(pair):
    name, jmodel, params, model, jfeed, tfeed = pair
    out = jmodel.apply({"params": params}, jfeed, training=False, catalog=True)
    with torch.no_grad():
        u_v = model(tfeed, catalog=True)["u_v"].numpy()
    np.testing.assert_allclose(u_v, np.asarray(out["u_v"]), rtol=0, atol=ATOL)
    table = model.catalog_item_table()
    assert table.dtype == torch.float32 and table.is_contiguous()
    if name == "FPMC":
        assert not model.catalog_raw_table
        np.testing.assert_array_equal(table.numpy(), np.asarray(out["i_table"]))
        assert table.shape == (model.item_num, 2 * EMB)
    else:
        assert "i_table" not in out
        np.testing.assert_array_equal(table.numpy(), params["i_embeddings"]["embedding"])
    # the catalog protocol scores candidates as the forward does
    with torch.no_grad():
        pred = model(tfeed)["prediction"]
    cat = (torch.from_numpy(u_v)[:, None, :] * table[tfeed["item_id"]]).sum(-1)
    np.testing.assert_allclose(cat.numpy(), pred.numpy(), rtol=0, atol=ATOL)


def test_param_count_and_exact_round_trip(pair):
    name, jmodel, params, model, jfeed, tfeed = pair
    assert sum(p.numel() for p in model.parameters()) == jcount(params)
    back = weights.to_flax_params(model.state_dict(), name)
    flat, flat_back = (flax.traverse_util.flatten_dict(t) for t in (params, back))
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        assert flat_back[path].shape == leaf.shape, path
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))


def test_l2_exempt_parameters_equal_jax(pair):
    name, jmodel, params, model, jfeed, tfeed = pair
    jmask = flax.traverse_util.flatten_dict(jbase._decay_mask(params))
    tmask = tbase._decay_mask(dict(model.named_parameters()))
    assert len(jmask) == len(tmask)
    for path, decayed in jmask.items():
        key, _ = weights._torch_leaf(name, path)
        assert tmask[key] == decayed, (path, key)
    exempt = {k for k, v in tmask.items() if not v}
    if name in ("SASRec", "GRU4Rec"):
        assert exempt and all(k.endswith(".bias") for k in exempt)


def test_training_flag_and_dropout_masks(pair, corpus):
    """Models without dropout give the same output in training; SASRec
    with dropout draws its masks from the generator it is given: the same
    seed gives the same masks, another seed others, and evaluation none."""
    name, jmodel, params, model, jfeed, tfeed = pair
    gen = lambda s: torch.Generator().manual_seed(s)            # noqa: E731
    with torch.no_grad():
        plain = model(tfeed)["prediction"]
        np.testing.assert_array_equal(model(tfeed, training=True, gen=gen(0))["prediction"].numpy(),
                                      plain.numpy())
    if name != "SASRec":
        return
    dropped = registry.get_model(name).from_args(_args(name, dropout=0.3), corpus)
    dropped.load_state_dict(model.state_dict())
    with torch.no_grad():
        a = dropped(tfeed, training=True, gen=gen(5))["prediction"]
        b = dropped(tfeed, training=True, gen=gen(5))["prediction"]
        c = dropped(tfeed, training=True, gen=gen(6))["prediction"]
        d = dropped(tfeed)["prediction"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, plain)


def test_dropout_semantics():
    x = torch.ones(400_000)
    y = layers.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert torch.all(y[kept] == 1.0 / 0.75)
    assert layers.dropout(x, 0.25, False, None) is x and layers.dropout(x, 0.0, True, None) is x
    assert torch.equal(layers.dropout(x, 1.0, True, None), torch.zeros_like(x))


def test_masked_gru_outputs_and_carry_equal_flax():
    """Outputs at every step, the final carry at lengths - 1, the
    lengths-0 row (flax takes the last step's carry there), and the
    gradients of every cell parameter."""
    rng = np.random.default_rng(3)
    seq = rng.normal(size=(7, 6, 5)).astype(np.float32)
    lengths = np.array([1, 6, 3, 0, 2, 5, 4], dtype=np.int32)
    fm = jlayers.MaskedGRU(9)
    params = _redraw(fm.init(jax.random.key(0), jnp.asarray(seq), jnp.asarray(lengths))["params"], 4)
    want_out, want_carry = fm.apply({"params": params}, jnp.asarray(seq), jnp.asarray(lengths))
    gru = layers.MaskedGRU(5, 9)
    sd = weights.from_flax_params({"rnn": params}, "GRU4Rec")
    gru.load_state_dict({k[len("rnn."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out, carry = gru(torch.from_numpy(seq), torch.from_numpy(lengths.astype(np.int64)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(carry.numpy(), np.asarray(want_carry), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(carry[0].numpy(), out[0, 0].numpy())
    np.testing.assert_array_equal(carry[3].numpy(), out[3, -1].numpy())
    # gradients of a weighted sum of outputs and carry, parameter by parameter
    wo, wc = rng.normal(size=out.shape).astype(np.float32), rng.normal(size=carry.shape).astype(np.float32)

    def jloss(p):
        o, c = fm.apply({"params": p}, jnp.asarray(seq), jnp.asarray(lengths))
        return (o * wo).sum() + (c * wc).sum()

    want_g = weights.from_flax_params({"rnn": jax.grad(jloss)(params)}, "GRU4Rec")
    out, carry = gru(torch.from_numpy(seq), torch.from_numpy(lengths.astype(np.int64)))
    ((out * torch.from_numpy(wo)).sum() + (carry * torch.from_numpy(wc)).sum()).backward()
    for name, p in gru.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g["rnn." + name].numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)


def _moments(x):
    x = np.asarray(x, np.float64).ravel()
    return x.std(), np.abs(x).max()


@pytest.mark.parametrize("glorot", [False, True])
def test_initialisers_match_flax_distributions(glorot):
    """The GRU cell's lecun-normal and orthogonal kernels and zero biases,
    LayerNorm's ones and zeros, and the dense init of either scheme: the
    torch draws have flax's std (within 3%), bound and structure."""
    H, D = 96, 128
    jlayers.set_dense_init("glorot" if glorot else "reference")
    layers.set_dense_init("glorot" if glorot else "reference")
    try:
        fcell = fnn.GRUCell(features=H)
        fparams = fcell.init(jax.random.key(1), jnp.zeros((1, H)), jnp.zeros((1, D)))["params"]
        fdense = jlayers.dense(H).init(jax.random.key(2), jnp.zeros((1, D)))["params"]
        cell, lin, ln = layers.GRUCell(D, H), layers.Dense(D, H), layers.LayerNorm(H)
        gen = torch.Generator().manual_seed(0)
        for mod in (cell, lin, ln):
            for m in mod.modules():
                for n, p in m.named_parameters(recurse=False):
                    with torch.no_grad():
                        p.copy_(layers.param_init(m, n)(p.shape, gen))
    finally:
        jlayers.set_dense_init("reference")
        layers.set_dense_init("reference")
    for g in ("ir", "iz", "in", "hr", "hz", "hn"):
        w = getattr(cell, g).weight.detach().numpy()
        fw = np.asarray(fparams[g]["kernel"]).T
        (s, m), (fs, fm_) = _moments(w), _moments(fw)
        assert abs(s / fs - 1) < 0.03, (g, s, fs)
        if g.startswith("h"):      # orthogonal
            np.testing.assert_allclose(w @ w.T, np.eye(H), atol=1e-5)
        else:                      # truncated at two standard deviations
            assert m <= 2 * np.sqrt(1.0 / D) / 0.87962566103423978 + 1e-6 and fm_ <= m * 1.05
    for g in ("ir", "iz", "in", "hn"):
        assert not getattr(cell, g).bias.detach().any()
    assert cell.hr.bias is None and cell.hz.bias is None
    assert torch.equal(ln.weight, torch.ones(H)) and not ln.bias.detach().any()
    (s, m), (fs, fm_) = _moments(lin.weight.detach()), _moments(fdense["kernel"])
    assert abs(s / fs - 1) < 0.03 and m <= max(fm_, 4 * fs) * 1.05
    if glorot:
        assert not lin.bias.detach().any() and m <= np.sqrt(6.0 / (D + H))
    else:
        assert abs(_moments(lin.bias.detach())[0] / 0.01 - 1) < 0.3


def test_model_registry_and_args_equal_jax():
    names = lambda p: {a.dest for a in p._actions}                 # noqa: E731
    for name in MODELS:
        jm, m = jregistry.get_model(name), registry.get_model(name)
        assert names(jm.parse_model_args(argparse.ArgumentParser())) == \
            names(m.parse_model_args(argparse.ArgumentParser())), name
        assert jm.extra_log_args == m.extra_log_args
        assert (jm.reader, jm.runner, jm.batcher) == (m.reader, m.runner, m.batcher)
        assert jm.supports_catalog == m.supports_catalog
        assert jm.catalog_raw_table == m.catalog_raw_table
