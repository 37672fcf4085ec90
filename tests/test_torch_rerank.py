"""The re-rankers in the port against the JAX package: the re-rank feeds of
both batchers with the same frozen ranker (BPRMFImpression and
SASRecImpression; scores, 'position' and 'padding_mask' exactly, also where
the ranker's scores tie, u_v / i_v / his_v at 1e-5), PRM, SetRank (IMSAB
and MSAB) and MIR in both modes forward at 1e-5 with the weights carried
across (`weights.from_flax_params`), the ranker config overlay (the JAX
package's, value for value), the checkpoint rules (the port's own
state_dict file and the JAX package's flax msgpack file load the same
weights; a file of neither kind raises; a missing one warns), the frozen lane (ranker bit-identical over training) and the
--tuneranker lane (the loaded ranker injected, then moved, with its own
optimizer state), the JAX package's --test_all error word for word, and
the two-stage recipe through the CLI with a learning test per re-ranker.

Small sizes: D = 8, one block of 2 heads, 8 hidden units, history 5.
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
import yaml

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import readers_all  # noqa: F401  (registers the JAX readers)
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import RERANK_TEST_ALL_ERROR, get_batcher
from rechorus_tpu_torch.models.reranker import _loader
from rechorus_tpu_torch.runners import base as tbase

ATOL = 1e-5
BASE = dict(path="", dataset="SynthImp", sep="\t", impression_idkey="time", emb_size=8, history_max=5,
            num_neg=1, dropout=0.0, test_all=0, gpu="", random_seed=0, loss_n="BPR",
            train_max_pos_item=3, train_max_neg_item=5, test_max_pos_item=3, test_max_neg_item=5,
            num_layers=1, num_heads=2, hidden_size=8, n_blocks=1, num_hidden_unit=8,
            setrank_type="IMSAB", tuneranker=0, model_path="", ranker_name="BPRMF",
            ranker_config_file="", ranker_model_file="")
# case -> (model, overrides)
CASES = {
    "PRMGeneral": ("PRMGeneral", {}),
    "PRMSequential-SASRec": ("PRMSequential", dict(ranker_name="SASRec")),
    "SetRankGeneral-IMSAB": ("SetRankGeneral", {}),
    "SetRankGeneral-MSAB": ("SetRankGeneral", dict(setrank_type="MSAB")),
    "SetRankSequential": ("SetRankSequential", {}),
    "MIRGeneral": ("MIRGeneral", {}),
    "MIRSequential-SASRec": ("MIRSequential", dict(ranker_name="SASRec")),
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
def _reset_logging():
    yield
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


def _redraw(params, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(rng.normal(size=x.shape).astype(np.float32) * scale), params)


def _ranker_files(root, ranker, tie_items):
    """A ranker `<ranker>Impression` with weights redrawn at O(0.3), saved
    twice: the JAX package's flax msgpack file and this package's state_dict
    file; item rows 2k and 2k + 1 below `tie_items` are made equal, so their
    scores tie exactly. Returns (flax file, torch file, config file)."""
    args = argparse.Namespace(**{**BASE, "path": root})
    name = ranker + "Impression"
    jcls = jregistry.get_model(name)
    corpus = jregistry.get_reader(jcls.reader)(args)
    jmodel = jcls.from_args(args, corpus)
    jb = jget_batcher(jcls.batcher)(corpus, jmodel, "train", args)
    feed = jax.jit(jb.train_feed)(jb.device_arrays(), jnp.arange(4, dtype=jnp.int32), jax.random.key(0))
    params = _redraw(jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, feed,
                                 training=False)["params"], 7)
    table = params["i_embeddings"]["embedding"]
    table[1:tie_items:2] = table[0:tie_items - 1:2]
    jfile, tfile, cfg = (os.path.join(root, f"{ranker}.{ext}") for ext in ("msgpack", "bin", "yaml"))
    with open(jfile, "wb") as f:
        f.write(flax.serialization.to_bytes({"params": params, "extra_vars": {}}))
    torch.save(weights.from_flax_params(params, name), tfile)
    with open(cfg, "w") as f:
        yaml.safe_dump({"emb_size": 8, "history_max": 99}, f)
    return jfile, tfile, cfg


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rerank")
    synthetic.make_impression_dataset(str(root / "SynthImp"), n_users=60, n_items=50, n_impressions=6,
                                      noise=0.3)
    synthetic.make_impression_dataset(str(root / "SynthImpLearn"))
    files = {r: _ranker_files(str(root), r, tie_items=40) for r in ("BPRMF", "SASRec")}
    return str(root), files


def _args(data_root, case, side, **kw):
    root, files = data_root
    name, over = CASES[case]
    over = {**over, **kw}
    ranker = over.get("ranker_name", "BPRMF")
    jfile, tfile, cfg = files[ranker]
    return name, argparse.Namespace(**{**BASE, "path": root, "ranker_config_file": cfg,
                                       "ranker_model_file": jfile if side == "jax" else tfile, **over})


def _torch_feed(jfeed):
    out = {}
    for k, v in jfeed.items():
        if hasattr(v, "shape"):
            a = np.asarray(v)
            kind = {"i": np.int64, "u": np.int64, "b": bool}.get(a.dtype.kind, np.float32)
            out[k] = torch.from_numpy(a.astype(kind))
    return out


def _built(data_root, case, phase="train", **kw):
    name, targs = _args(data_root, case, "port", **kw)
    _, jargs = _args(data_root, case, "jax", **kw)
    cls, jcls = registry.get_model(name), jregistry.get_model(name)
    corpus = registry.get_reader(cls.reader)(targs)
    jcorpus = jregistry.get_reader(jcls.reader)(jargs)
    model, jmodel = cls.from_args(targs, corpus), jcls.from_args(jargs, jcorpus)
    b = get_batcher(cls.batcher)(corpus, model, phase, targs)
    jb = jget_batcher(jcls.batcher)(jcorpus, jmodel, phase, jargs)
    return name, model, jmodel, b, jb, corpus, targs


@pytest.mark.parametrize("phase", ["train", "test"])
@pytest.mark.parametrize("case", ["PRMGeneral", "MIRGeneral", "PRMSequential-SASRec"])
def test_rerank_feeds_equal_jax(data_root, case, phase):
    """The frozen ranker's keys of a re-rank feed. Items 2k and 2k + 1 share
    a ranker vector, so a request holding both scores them equal: their
    'position' follows the column order in both packages (stable sorts)."""
    _, _, _, b, jb, _, _ = _built(data_root, case, phase)
    assert len(b) == len(jb) > 0 and b.arrays.keys() == jb.arrays.keys()
    idx = np.arange(min(48, len(b)))
    fn = "train_feed" if phase == "train" else "eval_feed"
    extra = (torch.Generator().manual_seed(0),) if phase == "train" else ()
    feed = getattr(b, fn)(b.device_arrays("cpu"), torch.from_numpy(idx), *extra)
    jfeed = getattr(jb, fn)(jb.device_arrays(), jnp.asarray(idx, jnp.int32),
                            *((jax.random.key(0),) if phase == "train" else ()))
    assert feed.keys() == jfeed.keys()
    assert {"scores", "position", "padding_mask", "u_v", "i_v"} <= set(feed)
    assert ("his_v" in feed) == ("Sequential" in case or "MIR" in case)
    for k in feed:
        if k == "batch_size":
            continue
        got, want = feed[k].numpy(), np.asarray(jfeed[k])
        assert got.shape == want.shape, k
        if k in ("scores", "u_v", "i_v", "his_v"):
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=k)
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
    # ties: equal finite scores inside a request, ranked in column order
    s = feed["scores"].numpy()
    tied = [(r, i, j) for r in range(len(s)) for i in range(s.shape[1]) for j in range(i + 1, s.shape[1])
            if np.isfinite(s[r, i]) and s[r, i] == s[r, j]]
    if "SASRec" not in case:
        assert tied, "the tie rows are in the feed"
    pos = feed["position"].numpy()
    assert all(pos[r, i] < pos[r, j] for r, i, j in tied)
    # the pads (-inf) come last, in column order
    for r in range(len(s)):
        pads = np.flatnonzero(~np.isfinite(s[r]))
        assert (np.diff(pos[r, pads]) == 1).all() and (pos[r, pads] >= s.shape[1] - len(pads)).all()


@pytest.mark.parametrize("case", list(CASES))
def test_rerankers_forward_loss_and_gradients_equal_flax(data_root, case):
    name, model, jmodel, b, jb, _, _ = _built(data_root, case)
    jfeed = jb.train_feed(jb.device_arrays(), jnp.arange(min(24, len(jb)), dtype=jnp.int32),
                          jax.random.key(0))
    jfeed = {k: v for k, v in jfeed.items() if k != "batch_size"}
    params = jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, jfeed,
                         training=False)["params"]
    # MIR's 500-200-80 head at O(0.3) weights scores O(100), where f32
    # rounding alone passes the tolerance: its weights are drawn at O(0.1)
    params = _redraw(params, 3, 0.1 if "MIR" in case else 0.3)
    model.load_state_dict(weights.from_flax_params(params, name), strict=True)
    tfeed = _torch_feed(jfeed)
    want = np.asarray(jmodel.apply({"params": params}, jfeed, training=False)["prediction"])
    got = model(tfeed)["prediction"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 0.05

    def jloss(p):
        return jmodel.loss(jmodel.apply({"params": p}, jfeed, training=True,
                                        rngs={"dropout": jax.random.key(2)}), jfeed)

    jl, jg = jax.value_and_grad(jloss)(params)
    loss = model.loss(model(tfeed, training=True, gen=torch.Generator().manual_seed(0)), tfeed)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= ATOL
    want_g = weights.from_flax_params(jax.device_get(jg), name)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=0, atol=ATOL, err_msg=k)
    back = weights.to_flax_params(model.state_dict(), name)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))


# ------------------------------------------------------ loader and lanes
def test_ranker_config_overlay_and_its_reader(data_root, tmp_path):
    _, args = _args(data_root, "PRMGeneral", "port", emb_size=32, history_max=5)
    r = _loader.ranker_args(args)
    assert (r.emb_size, r.history_max, args.emb_size) == (8, 5, 32)     # history_max stays the CLI's
    # the overlay of any YAML file is the JAX package's, value for value
    # (YAML 1.1 reads `1e-3` as a string, and so do both packages)
    from rechorus_tpu.models.reranker import _loader as jloader

    cfg = tmp_path / "c.yaml"
    cfg.write_text("emb_size: 16\nlr: 1e-3\nl2: 0.000001\nloss_n: softmaxCE   # a comment\n"
                   "num_layers: 2\nflag: true\nname: 'x'\nhistory_max: 99\n")
    args.ranker_config_file = str(cfg)
    got, want = vars(_loader.ranker_args(args)), vars(jloader.ranker_args(args))
    assert got == want
    assert {k: got[k] for k in ("emb_size", "lr", "l2", "flag", "history_max")} == \
        dict(emb_size=16, lr="1e-3", l2=1e-6, flag=True, history_max=5)


def test_checkpoint_rules(data_root, caplog):
    root, files = data_root
    _, args = _args(data_root, "PRMGeneral", "port")
    corpus = registry.get_reader("ImpressionReader")(args)
    with caplog.at_level(logging.INFO):
        ranker = _loader.load_ranker(args, corpus, torch.device("cpu"))
    assert f"Loaded frozen ranker from {files['BPRMF'][1]}" in caplog.text
    assert not ranker.training and not any(p.requires_grad for p in ranker.parameters())
    want = torch.load(files["BPRMF"][1])
    assert all(torch.equal(v, want[k]) for k, v in ranker.state_dict().items())
    caplog.clear()
    with caplog.at_level(logging.INFO):
        from_flax = _loader.load_ranker(argparse.Namespace(**{**vars(args), "ranker_model_file":
                                                              files["BPRMF"][0]}), corpus, torch.device("cpu"))
    assert f"Loaded frozen ranker from {files['BPRMF'][0]}" in caplog.text
    assert all(torch.equal(v, want[k]) for k, v in from_flax.state_dict().items())
    bad = os.path.join(root, "bad.bin")
    with open(bad, "wb") as f:
        f.write(b"\x00not a checkpoint")
    with pytest.raises(ValueError, match="not a checkpoint of BPRMFImpression"):
        _loader.load_ranker(argparse.Namespace(**{**vars(args), "ranker_model_file": bad}),
                            corpus, torch.device("cpu"))
    caplog.clear()
    missing = argparse.Namespace(**{**vars(args), "ranker_model_file": os.path.join(root, "none.bin")})
    _loader.load_ranker(missing, corpus, torch.device("cpu"))
    assert "not found; ranker is randomly initialized" in caplog.text


def _runner_and_state(data_root, case, **kw):
    name, model, _, b, _, corpus, targs = _built(data_root, case, **kw)
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    ns.__dict__.update(vars(targs))
    ns.__dict__.update(metric="NDCG,HR", topk="1,3", main_metric="NDCG@3", batch_size=32, lr=1e-2)
    runner = registry.get_runner(model.runner)(ns)
    state = runner.init_state(model, 0, b)
    return runner, state, b, b.device_arrays(runner.device)


def test_frozen_lane_keeps_the_ranker_bit_identical(data_root):
    runner, state, b, arr = _runner_and_state(data_root, "PRMGeneral")
    assert not any(k.startswith("ranker_module") for k in state.params)
    before = {k: v.clone() for k, v in b.ranker.state_dict().items()}
    own = {k: v.clone() for k, v in state.model.state_dict().items()}
    loss = runner.fit(state, b, arr, 1)
    assert np.isfinite(loss)
    assert all(torch.equal(v, before[k]) for k, v in b.ranker.state_dict().items())
    assert any(not torch.equal(v, own[k]) for k, v in state.model.state_dict().items())


@pytest.mark.parametrize("case", ["PRMGeneral", "MIRSequential-SASRec"])
def test_tuneranker_injects_then_moves_the_ranker(data_root, case):
    runner, state, b, arr = _runner_and_state(data_root, case, tuneranker=1)
    loaded = {k: v.clone() for k, v in b.ranker.state_dict().items()}
    module = state.model.ranker_module
    assert module.state_dict().keys() == loaded.keys()
    assert all(torch.equal(v, loaded[k]) for k, v in module.state_dict().items())
    keys = [k for k in state.params if k.startswith("ranker_module.")]
    assert keys and all(k in state.opt_state.slots["mu"] for k in keys)
    runner.fit(state, b, arr, 1)
    assert any(not torch.equal(v, loaded[k]) for k, v in module.state_dict().items())
    assert all(torch.equal(v, loaded[k]) for k, v in b.ranker.state_dict().items())
    assert any(float(state.opt_state.slots["mu"][k].abs().max()) > 0 for k in keys)


@pytest.mark.parametrize("name", ["PRMGeneral", "MIRSequential"])
def test_test_all_raises_the_jax_error(data_root, name):
    case = "PRMGeneral" if name == "PRMGeneral" else "MIRSequential-SASRec"
    with pytest.raises(ValueError) as got:
        _built(data_root, case, "test", test_all=1)
    with pytest.raises(ValueError) as want:
        _, jargs = _args(data_root, case, "jax", test_all=1)
        jcls = jregistry.get_model(name)
        jc = jregistry.get_reader(jcls.reader)(jargs)
        jget_batcher(jcls.batcher)(jc, jcls.from_args(jargs, jc), "test", jargs)
    assert str(got.value) == str(want.value) == RERANK_TEST_ALL_ERROR


# ------------------------------------------------------------------ the CLI
def _cli(root, tmp_path, tag, *argv):
    log = tmp_path / f"{tag}.log"
    port_main.build_parser_and_run(
        [*argv, "--emb_size", "16", "--lr", "1e-2", "--l2", "0", "--batch_size", "128",
         "--eval_batch_size", "128", "--early_stop", "40", "--topk", "2,5", "--metric", "NDCG,HR,MAP",
         "--train_max_pos_item", "5", "--train_max_neg_item", "8", "--test_max_pos_item", "5",
         "--test_max_neg_item", "8", "--history_max", "10", "--random_seed", "5", "--gpu", "",
         "--path", root, "--dataset", "SynthImpLearn", "--log_file", str(log),
         "--save_final_results", "0"])
    text = log.read_text()
    line = [ln for ln in text.splitlines() if ln.startswith("Test After Training")][-1]
    return text, {k: float(v) for k, v in (kv.split(":") for kv in line[line.index("(") + 1: -1].split(","))}


@pytest.fixture(scope="module")
def stage_one(data_root, tmp_path_factory):
    """The two-stage recipe's first stage: BPRMFImpression and
    SASRecImpression through the CLI, each with its config file."""
    root = data_root[0]
    tmp = tmp_path_factory.mktemp("stage1")
    out = {}
    for ranker, flags in (("BPRMF", []), ("SASRec", ["--num_layers", "1", "--num_heads", "2"])):
        ckpt = str(tmp / f"{ranker}.bin")
        _, res = _cli(root, tmp, ranker, "--model_name", ranker, "--model_mode", "Impression", *flags,
                      "--epoch", "10", "--model_path", ckpt)
        cfg = tmp / f"{ranker}.yaml"
        cfg.write_text("emb_size: 16\n")
        out[ranker] = (ckpt, str(cfg), res)
    return out


@pytest.mark.parametrize("name,mode,ranker,extra", [
    ("PRM", "General", "BPRMF", ["--n_blocks", "1", "--num_heads", "2", "--num_hidden_unit", "16"]),
    ("PRM", "Sequential", "SASRec", ["--n_blocks", "1", "--num_heads", "2", "--num_hidden_unit", "16"]),
    ("SetRank", "General", "BPRMF", ["--n_blocks", "1", "--num_heads", "2", "--num_hidden_unit", "16"]),
    ("SetRank", "General", "BPRMF", ["--n_blocks", "1", "--num_heads", "2", "--num_hidden_unit", "16",
                                     "--setrank_type", "MSAB"]),
    ("MIR", "General", "BPRMF", ["--num_heads", "2", "--num_hidden_unit", "16"]),
    ("PRM", "General", "BPRMF", ["--n_blocks", "1", "--num_heads", "2", "--num_hidden_unit", "16",
                                 "--tuneranker", "1"]),
])
def test_rerankers_learn_over_a_cli_ranker(data_root, stage_one, tmp_path, name, mode, ranker, extra):
    """The JAX package's learning test (tests/test_e2e_rerank.py:93-109):
    over a frozen ranker from the first stage, every re-ranker stays
    competitive; the log names the loaded ranker."""
    ckpt, cfg, _ = stage_one[ranker]
    text, res = _cli(data_root[0], tmp_path, "rr", "--model_name", name, "--model_mode", mode, *extra,
                     "--epoch", "8", "--ranker_name", ranker, "--ranker_config_file", cfg,
                     "--ranker_model_file", ckpt, "--model_path", str(tmp_path / "rr.bin"))
    assert f"Loaded frozen ranker from {ckpt}" in text
    assert np.isfinite(res["NDCG@2"]) and res["NDCG@2"] > 0.5, f"{name}{mode}: {res}"
