"""The sequential feed path of the port against the JAX package: SeqReader's
positions and histories, the fixed-shape history arrays and
SequentialBatcher's arrays and feeds, on the committed Grocery corpus and
on a small block-structured corpus whose timestamps tie within users.
Every comparison is exact.
"""
import argparse
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rechorus_tpu.data.batching import SequentialBatcher as JaxBatcher
from rechorus_tpu.data.readers import SeqReader as JaxReader
from rechorus_tpu.data.synthetic import make_topk_dataset
from rechorus_tpu_torch.data.batching import SequentialBatcher, get_batcher
from rechorus_tpu_torch.data.readers import SeqReader, csr_history

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


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
def tied_root(tmp_path_factory):
    """150 users x 80 items; times coarsened to 3-day buckets, so most
    users have rows that share a timestamp (across splits too)."""
    root = tmp_path_factory.mktemp("seq_tied")
    make_topk_dataset(str(root / "Tied"), n_users=150, n_items=80, n_per_user=10)
    for split in ("train", "dev", "test"):
        path = root / "Tied" / f"{split}.csv"
        df = pd.read_csv(path, sep="\t")
        df["time"] = df["time"] // (3 * 86400)
        df.to_csv(path, sep="\t", index=False)
    return root


@pytest.fixture(scope="module", params=["grocery", "tied"])
def readers(request, tied_root):
    if request.param == "grocery":
        args = argparse.Namespace(path=DATA, dataset="Grocery_and_Gourmet_Food", sep="\t")
    else:
        args = argparse.Namespace(path=str(tied_root), dataset="Tied", sep="\t")
    return SeqReader(args), JaxReader(args)


def test_tied_corpus_has_ties(tied_root):
    df = pd.concat([pd.read_csv(tied_root / "Tied" / f"{s}.csv", sep="\t") for s in ("train", "dev", "test")])
    assert df.duplicated(["user_id", "time"]).sum() > 100


def test_positions_and_user_his_equal_jax(readers):
    corpus, jcorpus = readers
    for split in ("train", "dev", "test"):
        np.testing.assert_array_equal(corpus.data_df[split]["position"].to_numpy(),
                                      jcorpus.data_df[split]["position"].to_numpy(), err_msg=split)
    np.testing.assert_array_equal(corpus.user_his.offsets, jcorpus.user_his.offsets)
    np.testing.assert_array_equal(corpus.user_his.flat, jcorpus.user_his.flat)


@pytest.mark.parametrize("history_max", [1, 5, 20])
def test_history_arrays_equal_jax(readers, history_max):
    corpus, jcorpus = readers
    for split in ("train", "dev", "test"):
        df = corpus.data_df[split]
        got = corpus.history_arrays(df, history_max)                # the native kernel
        plain = csr_history(corpus.user_his, df["user_id"].to_numpy(), df["position"].to_numpy(),
                            history_max, chunk=997)                 # several chunks
        want = jcorpus.history_arrays(jcorpus.data_df[split], history_max)
        for name, g, p, w in zip(("items", "times", "lengths"), got, plain, want):
            assert g.dtype == p.dtype == w.dtype and g.shape == p.shape == w.shape, (split, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{split}/{name}")
            np.testing.assert_array_equal(p, w, err_msg=f"{split}/{name}")


def _args(**kw):
    ns = argparse.Namespace(host_shard_input=0)
    ns.__dict__.update(kw)
    return ns


@pytest.mark.parametrize("test_all", [0, 1])
def test_sequential_batcher_equals_jax(readers, test_all):
    """Arrays and feeds of train, dev and test. Train negatives are
    injected as `_ep_neg_items`, so the train feed is deterministic."""
    corpus, jcorpus = readers
    model = argparse.Namespace(num_neg=2, test_all=test_all, history_max=5)
    rng = np.random.default_rng(test_all)
    assert get_batcher("sequential") is SequentialBatcher
    for phase in ("train", "dev", "test"):
        b, jb = SequentialBatcher(corpus, model, phase, _args()), JaxBatcher(jcorpus, model, phase, _args())
        assert len(b) == len(jb) and list(b.arrays) == list(jb.arrays), phase
        assert len(b) == int((corpus.data_df[phase]["position"] > 0).sum())
        for k in b.arrays:
            assert b.arrays[k].dtype == jb.arrays[k].dtype, f"{phase}/{k}"
            np.testing.assert_array_equal(b.arrays[k], jb.arrays[k], err_msg=f"{phase}/{k}")
        np.testing.assert_array_equal(b._df["user_id"], jb._df["user_id"])
        arrays, jarrays = b.device_arrays("cpu"), jb.device_arrays()
        assert all(t.dtype == torch.int64 for t in arrays.values())
        idx = rng.integers(0, len(b), size=64)
        if phase == "train":
            neg = rng.integers(1, corpus.n_items, size=(len(b), 2))
            arrays["_ep_neg_items"] = torch.from_numpy(neg)
            jarrays["_ep_neg_items"] = jnp.asarray(neg, jnp.int32)
            feed = b.train_feed(arrays, torch.from_numpy(idx), None)
            jfeed = jb.train_feed(jarrays, jnp.asarray(idx), None)
        else:
            feed = b.eval_feed(arrays, torch.from_numpy(idx))
            jfeed = jb.eval_feed(jarrays, jnp.asarray(idx))
        assert feed.keys() == jfeed.keys(), phase
        for k in feed:
            np.testing.assert_array_equal(np.asarray(feed[k]), np.asarray(jfeed[k]), err_msg=f"{phase}/{k}")


def test_host_shard_input_raises(readers):
    """--host_shard_input (which earlier slices refused) defers the three
    history arrays (`LazyRows`): any row range, and the whole, builds what
    the eager batcher holds."""
    from rechorus_tpu_torch.data.batching import LazyRows

    corpus, _ = readers
    model = argparse.Namespace(num_neg=1, test_all=0, history_max=5)
    eager = SequentialBatcher(corpus, model, "train", _args(host_shard_input=0))
    lazy = SequentialBatcher(corpus, model, "train", _args(host_shard_input=1))
    n = len(eager)
    for k in SequentialBatcher.HISTORY_KEYS:
        assert isinstance(lazy.arrays[k], LazyRows) and lazy.arrays[k].shape == eager.arrays[k].shape
        np.testing.assert_array_equal(lazy.arrays[k].materialize(), eager.arrays[k])
        np.testing.assert_array_equal(lazy.arrays[k][n // 3: n // 2], eager.arrays[k][n // 3: n // 2])
        pad = lazy.arrays[k].materialize(n - 2, n + 3)       # rows past the end are zeros
        np.testing.assert_array_equal(pad[:2], eager.arrays[k][n - 2:])
        assert not pad[2:].any()
    tensors = lazy.device_arrays("cpu")
    assert isinstance(tensors["history_items"], LazyRows) and tensors["user_id"].dtype == torch.int64
