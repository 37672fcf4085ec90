"""The CTR task family's data path and runner in the port against the JAX
package: `make_ctr_dataset`'s files (both protocols) byte for byte, the
context schema and feature matrices (a synthetic corpus with user, item and
situation features, and Grocery, whose `i_category` is a float feature by
the suffix rule), the three batchers' arrays and feeds, the pointwise losses
and the CTR metrics (AUC on tied scores, also against sklearn), `CTRRunner`
through the CLI with its (user_id, item_id, pCTR, label) export, the best
epoch's BatchNorm statistics through a reload, a TopK mode's `--test_all 1`
ranks by the dense and the tiled forward against the JAX runner's, and the
`--lazy_emb_adam 1`
behaviours of the two modes (TopK raises the JAX package's error before any
update, CTR warns and trains dense).
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

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import context as jcontext
from rechorus_tpu.data import synthetic as jsynthetic
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.data.readers import ContextReader as JaxContextReader
from rechorus_tpu.ops import losses as jlosses
from rechorus_tpu.ops import metrics as jmetrics
from rechorus_tpu.runners import base as jbase
from rechorus_tpu_torch import weights
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry
from rechorus_tpu_torch.data import context, synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.data.readers import ContextReader
from rechorus_tpu_torch.ops import losses, metrics
from rechorus_tpu_torch.runners import base as tbase
from rechorus_tpu_torch.runners.ctr import CTRRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROCERY = "Grocery_and_Gourmet_Food"
SYNTH = dict(n_users=120, n_items=110, n_per_user=14)
# the JAX package's words (rechorus_tpu/runners/base.py:633-636)
JAX_LAZY_ERROR = ("--lazy_emb_adam: lazy_table_specs matched no param/feed keys for this model's "
                  "train feed; remove the flag or fix the model's lazy_table_specs()")


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
    """A CTR corpus and a top-k one (the ML_1MTOPK contract), as the port
    writes them."""
    root = tmp_path_factory.mktemp("ctr")
    synthetic.make_ctr_dataset(str(root / "SynthCTR"), **SYNTH)
    synthetic.make_ctr_dataset(str(root / "SynthTOPK"), **SYNTH, topk=True, expose_bias=0.6)
    return root


@pytest.mark.parametrize("topk", [False, True])
def test_make_ctr_dataset_writes_the_jax_files(tmp_path, topk):
    kw = dict(n_users=60, n_items=130, n_per_user=9, n_groups=5, seed=4, expose_bias=0.5, topk=topk)
    assert synthetic.make_ctr_dataset(str(tmp_path / "port"), **kw) == \
        jsynthetic.make_ctr_dataset(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["dev.csv", "item_meta.csv", "test.csv", "train.csv", "user_meta.csv"]
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False), name
    assert ("neg_items" in pd.read_csv(tmp_path / "port" / "dev.csv", sep="\t")) == topk


def _reader_args(root, dataset, **kw):
    base = dict(path=str(root), dataset=dataset, sep="\t", include_item_features=1,
                include_user_features=1, include_situation_features=1)
    return argparse.Namespace(**{**base, **kw})


@pytest.fixture(scope="module")
def corpora(data_root):
    """{name: (port ContextReader, JAX ContextReader)}."""
    out = {}
    for name, args in (("synth", _reader_args(data_root, "SynthCTR")),
                       ("synth_items_only", _reader_args(data_root, "SynthCTR", include_user_features=0,
                                                         include_situation_features=0)),
                       ("grocery", _reader_args(os.path.join(ROOT, "data"), GROCERY))):
        out[name] = (ContextReader(args), JaxContextReader(args))
    return out


@pytest.mark.parametrize("name", ["synth", "synth_items_only", "grocery"])
def test_schema_and_feature_matrices_equal_jax(corpora, name):
    corpus, jcorpus = corpora[name]
    assert corpus.feature_max == jcorpus.feature_max
    schema, jschema = context.build_schema(corpus), jcontext.build_schema(jcorpus)
    assert schema.__dict__ == jschema.__dict__
    mats, jmats = context.feature_matrices(corpus), jcontext.feature_matrices(jcorpus)
    assert mats.keys() == jmats.keys()
    for k in mats:
        assert mats[k].dtype == jmats[k].dtype
        np.testing.assert_array_equal(mats[k], jmats[k], err_msg=k)
    if name == "grocery":
        # no situation columns and no user_meta.csv; i_category has no
        # _c / _f suffix, so it is a float feature (a Dense(1 -> d))
        assert schema.names == ("i_category", "user_id", "item_id")
        assert schema.kinds == ("float", "cat", "cat")
        assert mats["item"].shape == (corpus.n_items, 1) and mats["item"].max() > 1
    if name == "synth":
        assert schema.names == ("u_group_c", "i_category_c", "i_quality_f", "c_hour_c",
                                "user_id", "item_id")


def _model_args(name, mode, **kw):
    parser = registry.get_model(name, mode).parse_model_args(argparse.ArgumentParser())
    args = parser.parse_args([])
    args.__dict__.update({"emb_size": 8, "num_neg": 2, "test_all": 0, **kw})
    return args


@pytest.mark.parametrize("mode,phase,test_all", [
    ("CTR", "train", 0), ("CTR", "test", 0), ("TopK", "train", 0), ("TopK", "dev", 0),
    ("TopK", "test", 1)])
def test_context_batchers_equal_jax(data_root, mode, phase, test_all):
    """ContextCTRBatcher and ContextBatcher: the host arrays, then a feed of
    96 rows (a train feed's sampled negatives aside)."""
    args = _reader_args(data_root, "SynthCTR" if mode == "CTR" else "SynthTOPK")
    corpus, jcorpus = ContextReader(args), JaxContextReader(args)
    margs = _model_args("FM", mode, test_all=test_all)
    model = registry.get_model("FM", mode).from_args(margs, corpus)
    jmodel = jregistry.get_model("FM", mode).from_args(margs, jcorpus)
    b = get_batcher(model.batcher)(corpus, model, phase, margs)
    jb = jget_batcher(jmodel.batcher)(jcorpus, jmodel, phase, margs)
    assert type(b).__name__ == type(jb).__name__ and len(b) == len(jb)
    assert b.arrays.keys() == jb.arrays.keys()
    assert "situ_cat" in b.arrays and ("label" in b.arrays) == (mode == "CTR")
    for k in b.arrays:
        assert b.arrays[k].dtype == np.asarray(jb.arrays[k]).dtype, k
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    idx = np.sort(np.random.default_rng(0).choice(len(b), min(96, len(b)), replace=False))
    arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
    tidx, jidx = torch.from_numpy(idx), jnp.asarray(idx, jnp.int32)
    if phase == "train":
        feed = b.train_feed(arrays, tidx, torch.Generator().manual_seed(0))
        jfeed = jb.train_feed(jarrays, jidx, jax.random.key(0))
    else:
        feed, jfeed = b.eval_feed(arrays, tidx), jb.eval_feed(jarrays, jidx)
    assert feed.keys() == jfeed.keys()
    for k in feed:
        if k == "batch_size":
            assert feed[k] == jfeed[k]
            continue
        got, want = feed[k].numpy(), np.asarray(jfeed[k])
        if k == "item_id" and phase == "train" and mode == "TopK":
            got, want = got[:, 0], want[:, 0]               # the sampled negatives differ
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_plain_ctr_batcher_equals_jax(corpora):
    corpus, jcorpus = corpora["synth"]
    b = get_batcher("ctr")(corpus, None, "dev", argparse.Namespace())
    jb = jget_batcher("ctr")(jcorpus, None, "dev", argparse.Namespace())
    assert b.arrays.keys() == {"user_id", "target_item", "label"} == jb.arrays.keys()
    for k in b.arrays:
        np.testing.assert_array_equal(b.arrays[k], np.asarray(jb.arrays[k]), err_msg=k)
    feed = b.eval_feed(b.device_arrays("cpu"), torch.arange(5))
    assert feed["item_id"].shape == (5, 1) and feed["label"].dtype == torch.float32


# ------------------------------------------------------ losses and metrics
@pytest.mark.parametrize("which", ["bce", "mse"])
def test_pointwise_losses_equal_jax(which):
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 1, 200).astype(np.float32)
    p[:3] = [0.0, 1.0, 1e-9]                                  # the clip at 1e-7 acts
    y = (rng.random(200) < 0.5).astype(np.float32)
    jfn, fn = getattr(jlosses, which), getattr(losses, which)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(p), jnp.asarray(y))
    t = torch.from_numpy(p).requires_grad_(True)
    got = fn(t, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_ctr_metrics_equal_jax_and_sklearn(ties):
    rng = np.random.default_rng(2)
    y = (rng.random(500) < 0.3).astype(np.float32)
    p = rng.uniform(0, 1, 500).astype(np.float32)
    if ties:
        p = np.round(p * 8) / 8                               # nine distinct scores
        p[:40] = 0.5
    names = ["AUC", "LOG_LOSS", "ACC", "F1_SCORE"]
    got = metrics.evaluate_ctr(p, y, names)
    assert got == jmetrics.evaluate_ctr(p, y, names)
    assert 0.0 < got["F1_SCORE"] < 1.0 and 0.0 < got["ACC"] < 1.0
    sk = pytest.importorskip("sklearn.metrics")
    assert got["AUC"] == pytest.approx(sk.roc_auc_score(y, p), abs=1e-12)
    assert got["LOG_LOSS"] == pytest.approx(sk.log_loss(y, np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)), abs=1e-9)
    with pytest.raises(ValueError):
        metrics.evaluate_ctr(p, y, ["NDCG"])


# ------------------------------------------------------------- the runner
def _run(data_root, tmp_path, model, mode, *extra, epochs=3, tag="run"):
    log = tmp_path / f"{tag}.log"
    argv = ["--model_name", model, "--model_mode", mode, "--emb_size", "8", "--lr", "1e-2",
            "--dataset", "SynthCTR" if mode == "CTR" else "SynthTOPK", "--path", str(data_root),
            "--gpu", "", "--epoch", str(epochs), "--batch_size", "128", "--include_item_features", "1",
            "--include_user_features", "1", "--include_situation_features", "1",
            "--log_file", str(log), "--model_path", str(tmp_path / f"{tag}.bin"), *extra]
    state = port_main.build_parser_and_run(argv)
    return state, log.read_text()


def _line(text, prefix):
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    body = line[line.index("(") + 1: line.rindex(")")]
    return {k: float(v) for k, v in (kv.split(":") for kv in body.split(","))}


def test_ctr_runner_through_the_cli_and_its_export(data_root, tmp_path):
    state, text = _run(data_root, tmp_path, "FM", "CTR", "--metric", "AUC,LOG_LOSS,ACC,F1_SCORE")
    test = _line(text, "Test After Training")
    assert set(test) == {"AUC", "LOG_LOSS", "ACC", "F1_SCORE"}
    assert all(np.isfinite(v) for v in test.values())
    assert "\tdev=(ACC:" in text and "Best Iter(dev)" in text
    export = pd.read_csv(data_root / "SynthCTR" / "rec-FMCTR-test.csv", sep="\t")
    df = pd.read_csv(data_root / "SynthCTR" / "test.csv", sep="\t").sort_values(["user_id", "time"])
    assert list(export.columns) == ["user_id", "item_id", "pCTR", "label"]
    assert len(export) == len(df)
    np.testing.assert_array_equal(export["user_id"], df["user_id"])
    np.testing.assert_array_equal(export["item_id"], df["item_id"])
    np.testing.assert_array_equal(export["label"], df["label"])
    args, model_cls, reader_cls, runner_cls = port_main.parse_cli(
        ["--model_name", "FM", "--model_mode", "CTR", "--dataset", "SynthCTR", "--path", str(data_root),
         "--gpu", "", "--include_item_features", "1", "--include_user_features", "1",
         "--include_situation_features", "1", "--metric", "AUC"])
    assert runner_cls is CTRRunner
    runner = runner_cls(args)
    assert runner.main_metric == "AUC" and runner.main_topk == 0
    corpus = port_main.build_corpus(args, reader_cls)
    batcher = get_batcher(model_cls.batcher)(corpus, state.model, "test", args)
    preds, labels = runner.predict(state, batcher, batcher.device_arrays("cpu"), "test")
    np.testing.assert_array_equal(export["pCTR"].to_numpy().astype(np.float32), preds)
    assert test["AUC"] == pytest.approx(metrics.auc_score(labels, preds), abs=1e-4)


def test_dcn_reload_reproduces_the_best_epoch_with_its_batch_stats(data_root, tmp_path):
    """DCN's deep tower normalises with flax's BatchNorm: the best epoch's
    checkpoint carries the running statistics, so `--load 1 --train 0`
    reproduces the test metrics."""
    flags = ["--layers", "[16]", "--cross_layer_num", "2", "--metric", "AUC,LOG_LOSS",
             "--save_final_results", "0"]
    state, text = _run(data_root, tmp_path, "DCN", "CTR", *flags, tag="dcn")
    saved = weights.read_checkpoint(str(tmp_path / "dcn.bin"), state.model)
    assert {"deep_layers.bn_0.running_mean", "deep_layers.bn_0.running_var"} <= saved.keys()
    assert not torch.equal(saved["deep_layers.bn_0.running_var"], torch.ones(16))
    assert not any(k in saved for k in ("item_cat", "user_cat", "item_float"))
    _, text2 = _run(data_root, tmp_path, "DCN", "CTR", *flags, "--load", "1", "--train", "0", tag="dcn")
    assert _line(text2, "Test Before Training") == _line(text, "Test After Training")


def _runner_and_state(data_root, name, mode, **kw):
    ns = tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args([])
    args = _model_args(name, mode)
    args.__dict__.update({**ns.__dict__, **_reader_args(
        data_root, "SynthCTR" if mode == "CTR" else "SynthTOPK").__dict__,
        "gpu": "", "random_seed": 0, "model_path": "", "batch_size": 64,
        "metric": "AUC" if mode == "CTR" else "HR", **kw})
    model_cls = registry.get_model(name, mode)
    corpus = ContextReader(args)
    model = model_cls.from_args(args, corpus)
    runner = registry.get_runner(model_cls.runner)(args)
    batcher = get_batcher(model_cls.batcher)(corpus, model, "train", args)
    state = runner.init_state(model, 0)
    return runner, state, batcher, batcher.device_arrays(runner.device)


def test_lazy_emb_adam_topk_raises_before_any_update(data_root):
    """ContextModel inherits GeneralModel's lazy tables, which its
    parameters lack: the lazy lane is entered, resolves no table, and the
    first step raises the JAX package's error (rechorus_tpu/runners/
    base.py:633-636), with no parameter moved."""
    runner, state, batcher, arrays = _runner_and_state(data_root, "FM", "TopK", lazy_emb_adam=1)
    assert runner._lazy_specs                                 # the lane was entered
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(ValueError) as err:
        runner.fit(state, batcher, arrays, 1, max_steps=2)
    assert str(err.value) == JAX_LAZY_ERROR
    assert state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


def test_lazy_emb_adam_ctr_warns_and_trains_dense(data_root, caplog):
    with caplog.at_level(logging.WARNING):
        runner, state, batcher, arrays = _runner_and_state(data_root, "FM", "CTR", lazy_emb_adam=1)
    assert "FMCTR declares no lazy tables; dense optimizer" in caplog.text
    assert runner._lazy_specs == {} and isinstance(runner._tx, tbase.DenseOptimizer)
    before = state.model.bank.fused_table.weight.detach().clone()
    loss = runner.fit(state, batcher, arrays, 1, max_steps=3)
    assert np.isfinite(loss) and state.step == 3
    assert not torch.equal(state.model.bank.fused_table.weight, before)


@pytest.mark.parametrize("chunk", [8192, 23], ids=["dense", "tiled"])
def test_topk_test_all_ranks_equal_jax(data_root, chunk):
    """`--test_all 1` for a context TopK model: each test row ranked over the
    whole catalog through the model's forward (B1 on the card), by the
    dense route and, at a 23-candidate chunk, the tiled one; equal to the
    JAX runner's ranks with the same weights."""
    rargs = _reader_args(data_root, "SynthTOPK")
    corpus, jcorpus = ContextReader(rargs), JaxContextReader(rargs)
    flags = ["--eval_batch_size", "32", "--eval_candidate_chunk", str(chunk)]
    args = _model_args("xDeepFM", "TopK", test_all=1, layers="[16]", cin_layers="[4]")
    jargs = argparse.Namespace(**vars(args))
    args.__dict__.update({**vars(tbase.BaseRunner.parse_runner_args(argparse.ArgumentParser())
                                 .parse_args(flags)), **vars(rargs), "gpu": "", "random_seed": 0})
    jargs.__dict__.update({**vars(jbase.BaseRunner.parse_runner_args(argparse.ArgumentParser())
                                  .parse_args(flags)), **vars(rargs), "random_seed": 0})
    jmodel = jregistry.get_model("xDeepFM", "TopK").from_args(jargs, jcorpus)
    jrunner = jbase.BaseRunner(jargs)
    jb = {p: jget_batcher(jmodel.batcher)(jcorpus, jmodel, p, jargs) for p in ("train", "test")}
    jstate = jrunner.init_state(jmodel, jb["train"], 0)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.3).astype(np.float32),
                          jax.device_get(jstate.params))
    want = jrunner.predict_ranks(jstate.replace(params=params), jmodel, jb["test"],
                                 jb["test"].device_arrays(), "test")
    model = registry.get_model("xDeepFM", "TopK").from_args(args, corpus)
    runner = tbase.BaseRunner(args)
    state = runner.init_state(model, 0)
    model.load_state_dict(weights.from_flax_params(params, "xDeepFMTopK"))
    b = get_batcher(model.batcher)(corpus, model, "test", args)
    arrays = b.device_arrays("cpu")
    assert runner._use_tiled_forward(model, b, arrays) == (chunk < corpus.n_items)
    got = runner.predict_ranks(state, b, arrays, "test")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert ((got >= 1) & (got <= corpus.n_items)).all() and len(set(got.tolist())) > 10
