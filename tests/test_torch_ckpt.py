"""Checkpoints that either package reads: the port's msgpack codec
(`utils.flax_msgpack`) byte for byte against flax's on random trees (f32,
bf16, int32, numpy scalars, nested maps, chunked arrays); the JAX
package's `BaseRunner.save_model` file loading through the port's
`load_model`, and the port's file through the JAX package's, with equal
predictions (1e-5) for BPRMF, SASRec, DCNCTR (`batch_stats`), ETACTR
(`constants`), BUIR (`target`) and a --bf16_emb BPRMF; S3Rec's stage 2
starting from a `Pre__` file of either package; and a state_dict file of
the port's earlier format still loading.
"""
import argparse
import os

import flax
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import readers_all  # noqa: F401  (registers the JAX readers)
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.ops import layers as jlayers
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.runners import base as tbase
from rechorus_tpu_torch.utils import flax_msgpack

ATOL = RTOL = 1e-5


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
    jlayers.set_table_dtype(None)


# ------------------------------------------------------------------ codec
def _bf16_pair(rng, shape):
    """(numpy ml_dtypes bfloat16 array, the torch.bfloat16 tensor of it)."""
    a = rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    return a, torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _random_tree(seed):
    """(tree for flax, the same tree for the port: bfloat16 leaves as torch
    tensors)."""
    rng = np.random.default_rng(seed)
    bf, tbf = _bf16_pair(rng, (3, 5))
    bf0, tbf0 = _bf16_pair(rng, ())
    leaves = {
        "kernel": rng.normal(size=(4, 7)).astype(np.float32),
        "ids": rng.integers(-2 ** 31, 2 ** 31 - 1, size=(11,)).astype(np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "scalar_array": np.asarray(1.25, np.float32),
        "f64": rng.normal(size=(2, 2)),
        "mask": rng.random(5) > 0.5,
    }
    scalars = {"np_f32": np.float32(rng.normal()), "np_i64": np.int64(-7), "py_int": 300,
               "py_neg": -40000, "py_float": 0.5, "py_str": "x" * 40, "none": None, "yes": True}
    jtree = {"params": {"dense_0": {"kernel": leaves["kernel"], "bias": leaves["f64"][0]},
                        "table": bf, "deep": {"a": {"b": {"c": leaves["ids"]}}}},
             "extra_vars": {"constants": {"empty": leaves["empty"], "s": leaves["scalar_array"],
                                          "mask": leaves["mask"], "bf0": bf0}},
             "meta": scalars}
    ttree = {"params": {**jtree["params"], "table": tbf},
             "extra_vars": {"constants": {**jtree["extra_vars"]["constants"], "bf0": tbf0}},
             "meta": scalars}
    return jtree, ttree


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("chunk", [None, 24], ids=["whole", "chunked"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_bytes_equal_flax(seed, chunk, monkeypatch):
    """`serialize` gives flax.serialization.to_bytes' bytes, and `restore`
    flax's msgpack_restore's tree, for either side's bytes; with a small
    MAX_CHUNK_SIZE (set in both, for this test only) the arrays over it
    are written and read in flax's chunked form."""
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    jtree, ttree = _random_tree(seed)
    want = flax.serialization.to_bytes(jtree)
    got = flax_msgpack.serialize(ttree)
    assert got == want
    if chunk:
        assert b"__msgpack_chunked_array__" in got
    restored = flax.serialization.msgpack_restore(want)
    _same(flax_msgpack.restore(want), restored)
    _same(flax_msgpack.restore(got), restored)


def test_codec_rejects_what_flax_cannot_read():
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(flax.serialization.to_bytes({"a": np.zeros(4, np.float32)})[:-3])
    with pytest.raises(TypeError):
        flax_msgpack.serialize({"a": object()})


# ------------------------------------------------------ runner round trips
CKPT_CASES = {  # case -> (model, mode, dataset, model flags, runner flags)
    "BPRMF": ("BPRMF", "", "Synth", dict(emb_size=8), {}),
    "BPRMF-bf16": ("BPRMF", "", "Synth", dict(emb_size=8), dict(bf16_emb=1, lazy_emb_adam=1)),
    "SASRec": ("SASRec", "", "Synth", dict(emb_size=8, num_layers=1, num_heads=2, history_max=5), {}),
    "DCNCTR": ("DCN", "CTR", "SynthCTR", dict(emb_size=8, layers="[8]", cross_layer_num=1), {}),
    "ETACTR": ("ETA", "CTR", "SynthCTR", dict(emb_size=8, dnn_hidden_units="[8]", attention_dim=8,
                                             num_heads=2, retrieval_k=3, hash_bits=2, recent_k=3,
                                             history_max=6), {}),
    "BUIR": ("BUIR", "", "Synth", dict(emb_size=8), {}),
}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    synthetic.make_topk_dataset(str(root / "Synth"), n_users=40, n_items=60, n_per_user=8, n_neg=9)
    synthetic.make_ctr_dataset(str(root / "SynthCTR"), n_users=40, n_items=50, n_per_user=10)
    return str(root)


def _args(root, model, mode, dataset, flags, runner_flags, **kw):
    cls = registry.get_model(model, mode)
    parser = argparse.ArgumentParser()
    registry.get_reader(cls.reader).parse_data_args(parser)
    tbase.BaseRunner.parse_runner_args(parser)
    cls.parse_model_args(parser)
    args = parser.parse_args([])
    args.__dict__.update(path=root, dataset=dataset, gpu="", random_seed=0, include_item_features=1,
                         include_user_features=1, include_situation_features=1, eval_batch_size=16,
                         **flags, **runner_flags, **kw)
    return args


def _redraw_state(state, seed):
    """The JAX state with its params (and batch_stats, BUIR's targets)
    redrawn at O(0.3) in their own dtypes; variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        return jnp.asarray((rng.normal(size=x.shape) * 0.3).astype(x.dtype))

    extra = dict(state.extra_vars)
    if "batch_stats" in extra:
        extra["batch_stats"] = flax.traverse_util.unflatten_dict({
            p: (jnp.asarray(rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)) if p[-1] == "var"
                else draw(v)) for p, v in flax.traverse_util.flatten_dict(extra["batch_stats"]).items()})
    if "target" in extra:
        extra["target"] = jax.tree.map(draw, extra["target"])
    return state.replace(params=jax.tree.map(draw, state.params), extra_vars=extra)


def _pair(root, case, tmp):
    """(JAX model, runner, state with redrawn weights, eval feed) and (port
    model, runner, state, eval feed) of one corpus and command."""
    model, mode, dataset, flags, rflags = CKPT_CASES[case]
    args = _args(root, model, mode, dataset, flags, rflags, model_path=os.path.join(tmp, "m.bin"))
    jargs = argparse.Namespace(**vars(args))
    jcls, cls = jregistry.get_model(model, mode), registry.get_model(model, mode)
    jrunner = jregistry.get_runner(jcls.runner)(jargs)
    jcorpus = jregistry.get_reader(jcls.reader)(jargs)
    jmodel = jcls.from_args(jargs, jcorpus)
    jb = {p: jget_batcher(jcls.batcher)(jcorpus, jmodel, p, jargs) for p in ("train", "dev")}
    jstate = _redraw_state(jrunner.init_state(jmodel, jb["train"], 0), 1)
    runner = registry.get_runner(cls.runner)(args)
    corpus = registry.get_reader(cls.reader)(args)
    tmodel = cls.from_args(args, corpus)
    b = {p: get_batcher(cls.batcher)(corpus, tmodel, p, args) for p in ("train", "dev")}
    state = runner.init_state(tmodel, 0, b["train"])
    idx = np.arange(min(16, len(b["dev"])))
    jfeed = jax.jit(jb["dev"].eval_feed)(jb["dev"].device_arrays(), jnp.asarray(idx, jnp.int32))
    feed = b["dev"].eval_feed(b["dev"].device_arrays("cpu"), torch.from_numpy(idx))
    return (jmodel, jrunner, jstate, jfeed), (tmodel, runner, state, feed)


def _jax_pred(jmodel, jstate, jfeed):
    variables = {"params": jstate.params, **jstate.extra_vars}
    return np.asarray(jax.jit(lambda v, f: jmodel.apply(v, f, training=False))(variables, jfeed)["prediction"])


def _port_pred(state, feed):
    state.model.eval()
    with torch.no_grad():
        return state.model(feed)["prediction"].float().numpy()


def _structure(tree):
    """{path: (shape, dtype name)} of a restored checkpoint tree."""
    return {p: (tuple(v.shape), "bfloat16" if isinstance(v, torch.Tensor) else v.dtype.name)
            for p, v in flax.traverse_util.flatten_dict(tree).items()}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_checkpoints_cross_between_the_packages(data_root, tmp_path, case):
    (jmodel, jrunner, jstate, jfeed), (tmodel, runner, state, feed) = _pair(data_root, case, str(tmp_path))
    # the JAX package's file -> the port's load_model
    jfile = str(tmp_path / "jax.bin")
    jrunner.save_model(jstate, jfile)
    runner.load_model(state, jfile)
    want = _jax_pred(jmodel, jstate, jfeed)
    assert np.abs(want).max() > 0.1, "O(1) scores"
    np.testing.assert_allclose(_port_pred(state, feed), want, rtol=RTOL, atol=ATOL)
    # the port's file -> the JAX package's load_model: other weights first
    other = _redraw_state(jstate, 2)
    sd = weights.from_flax_params(jax.device_get(other.params), tmodel.registered_name)
    for collection in ("batch_stats", "target"):
        if collection in other.extra_vars:
            sd.update(weights.from_flax_params(jax.device_get(other.extra_vars[collection]),
                                               tmodel.registered_name))
    tmodel.load_state_dict(sd, strict=False)
    tfile = str(tmp_path / "port.bin")
    runner.save_model(state, tfile)
    with open(tfile, "rb") as f:
        data = f.read()
    with open(jfile, "rb") as f:
        assert _structure(flax_msgpack.restore(data)) == _structure(flax_msgpack.restore(f.read()))
    restored = jrunner.load_model(jstate, tfile)
    for p, leaf in flax.traverse_util.flatten_dict(jax.device_get(other.params)).items():
        got = flax.traverse_util.flatten_dict(restored.params)[p]
        assert got.dtype == leaf.dtype, p
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf), err_msg="/".join(p))
    want = _jax_pred(jmodel, restored, jfeed)
    np.testing.assert_allclose(_port_pred(state, feed), want, rtol=RTOL, atol=ATOL)
    if case == "BPRMF-bf16":
        assert tmodel.i_embeddings.weight.dtype == torch.bfloat16
        assert np.asarray(restored.params["i_embeddings"]["embedding"]).dtype == ml_dtypes.bfloat16


def test_earlier_state_dict_files_still_load(data_root, tmp_path):
    (_, _, _, _), (tmodel, runner, state, feed) = _pair(data_root, "DCNCTR", str(tmp_path))
    with torch.no_grad():
        for p in tmodel.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(0)))
    saved = {k: v.clone() for k, v in tmodel.state_dict().items()}
    path = str(tmp_path / "old.bin")
    torch.save(saved, path)
    assert open(path, "rb").read(4) == weights.ZIP_MAGIC
    state.model.init_weights(torch.Generator().manual_seed(1))
    runner.load_model(state, path)
    assert all(torch.equal(v, saved[k]) for k, v in tmodel.state_dict().items())
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch state_dict file nor a flax msgpack"):
        runner.load_model(state, path)


def _s3rec(root, tmp, stage, side):
    args = _args(root, "S3Rec", "", "Synth", dict(emb_size=8, history_max=5, stage=stage), {},
                 model_path=os.path.join(tmp, "S3Rec", "x.bin"))
    if side == "jax":
        cls = jregistry.get_model("S3Rec")
        runner = jregistry.get_runner(cls.runner)(args)
        corpus = jregistry.get_reader(cls.reader)(args)
        model = cls.from_args(args, corpus)
        b = {p: jget_batcher(cls.batcher)(corpus, model, p, args) for p in ("train", "dev")}
        return model, runner, b, args
    cls = registry.get_model("S3Rec")
    runner = registry.get_runner(cls.runner)(args)
    corpus = registry.get_reader(cls.reader)(args)
    model = cls.from_args(args, corpus)
    b = {p: get_batcher(cls.batcher)(corpus, model, p, args) for p in ("train", "dev")}
    return model, runner, b, args


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_s3rec_stage2_starts_from_either_packages_pretrain_file(data_root, tmp_path, writer):
    """Stage 1 of one package writes Pre__Synth.bin beside --model_path;
    stage 2 of both packages starts from it: the same encoder and table,
    the same predictions."""
    tmp = str(tmp_path)
    model1, runner1, b1, args1 = _s3rec(data_root, tmp, 1, writer)
    pre = os.path.join(tmp, "S3Rec", "Pre__Synth.bin")
    assert args1.model_path == pre
    if writer == "jax":
        runner1.save_model(_redraw_state(runner1.init_state(model1, b1["train"], 0), 3), pre)
    else:
        state1 = runner1.init_state(model1, 0, b1["train"])
        with torch.no_grad():
            for p in model1.parameters():
                p.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(3))
        runner1.save_model(state1, pre)
    jmodel, jrunner, jb, _ = _s3rec(data_root, tmp, 2, "jax")
    jstate = jrunner.init_state(jmodel, jb["train"], 0)
    tmodel, runner, b, _ = _s3rec(data_root, tmp, 2, "port")
    state = runner.init_state(tmodel, 0, b["train"])
    want = weights.from_flax_params(jax.device_get(jstate.params), "S3Rec")
    got = tmodel.state_dict()
    assert want.keys() == got.keys() and "mip_norm.weight" not in got
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    if writer == "port":
        saved = model1.state_dict()
        assert all(torch.equal(got[k], saved[k]) for k in got)
    idx = np.arange(16)
    jfeed = jax.jit(jb["dev"].eval_feed)(jb["dev"].device_arrays(), jnp.asarray(idx, jnp.int32))
    feed = b["dev"].eval_feed(b["dev"].device_arrays("cpu"), torch.from_numpy(idx))
    want = _jax_pred(jmodel, jstate, jfeed)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(_port_pred(state, feed), want, rtol=RTOL, atol=ATOL)
