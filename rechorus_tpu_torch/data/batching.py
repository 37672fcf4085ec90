"""Fixed-shape device-resident batch pipelines (port of
rechorus_tpu/data/batching.py:26-38 and 83-1232).

The whole corpus becomes a dict of tensors placed on the runner's device
once, and feeds are assembled by index gather there -- negative sampling
and candidate assembly are device compute, with no per-step host->device
traffic.

A `Batcher` holds:
  * host-side numpy arrays built once from the reader (`build`),
  * static config (num_neg, candidate counts),
  * feed functions `train_feed(arrays, idx, gen)` and
    `eval_feed(arrays, idx)` over the placed tensors.

Id arrays are int32 on the host (as in the JAX package) and int64 on the
device, which is what torch indexes with. The deferred `LazyRows` arrays
of `--host_shard_input` come with the sharded path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rechorus_tpu_torch.ops import kg as kg_ops
from rechorus_tpu_torch.ops import sampling
from rechorus_tpu_torch.runners.base import device_of_gpu_flag

BATCHER_REGISTRY: Dict[str, type] = {}


def register_batcher(name):
    def deco(cls):
        BATCHER_REGISTRY[name] = cls
        return cls

    return deco


def get_batcher(name: str):
    if name not in BATCHER_REGISTRY:
        raise KeyError(f"Unknown batcher '{name}': not ported yet. "
                       f"Registered: {sorted(BATCHER_REGISTRY)}")
    return BATCHER_REGISTRY[name]


class LazyRows:
    """Deferred per-row array (port of rechorus_tpu/data/batching.py:41-83):
    `build(lo, hi)` returns rows [lo, hi) as numpy. Under
    `--host_shard_input` the history arrays stay in this form until
    `BaseRunner.place_arrays`, which builds only this rank's 'data' row
    block (a one-process run builds the whole range): a host's corpus
    memory scales 1 / number of hosts."""

    __slots__ = ("shape", "dtype", "build")

    def __init__(self, shape, dtype, build):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.build = build

    def __getitem__(self, key) -> np.ndarray:
        # a contiguous [lo:hi] slice materializes the range (host-side
        # precomputes such as SLRC's and Chorus's intervals stream row chunks)
        if not (isinstance(key, slice) and key.step in (None, 1)):
            raise TypeError("LazyRows supports only contiguous [lo:hi] slices")
        lo, hi, _ = key.indices(self.shape[0])
        return self.materialize(lo, hi)

    def materialize(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """Rows [lo, hi); rows past the logical end (divisibility padding)
        are zeros."""
        hi = self.shape[0] if hi is None else hi
        real_hi = min(hi, self.shape[0])
        out = np.asarray(self.build(lo, real_hi), dtype=self.dtype)
        if hi > real_hi:
            out = np.concatenate([out, np.zeros((hi - real_hi,) + self.shape[1:], self.dtype)])
        return out

    def tensor(self, device, lo: int = 0, hi: int | None = None) -> torch.Tensor:
        return to_tensor(self.materialize(lo, hi), device)


def to_tensor(v: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`; integer arrays widen to int64."""
    t = torch.from_numpy(np.ascontiguousarray(v))
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


class Batcher:
    """Base: one instance per (corpus, phase)."""

    def __init__(self, corpus, model, phase: str, args):
        self.corpus = corpus
        self.model = model
        self.phase = phase
        self.args = args
        self.arrays: Dict[str, np.ndarray] = {}
        self.n = 0
        self.build()

    def __len__(self):
        return self.n

    def build(self):
        raise NotImplementedError

    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        """The host arrays as tensors on `device`; integer arrays widen to
        int64 there. Deferred arrays (`LazyRows`) stay deferred for
        `BaseRunner.place_arrays`."""
        return {k: (v if isinstance(v, LazyRows) else to_tensor(v, device))
                for k, v in self.arrays.items()}

    def train_feed(self, arrays, idx, gen):
        raise NotImplementedError

    def eval_feed(self, arrays, idx, cands=None):
        raise NotImplementedError

    def epoch_arrays(self, arrays, gen) -> Dict[str, torch.Tensor]:
        """Once-per-epoch stage, run before the step loop; returned entries
        are merged into `arrays` for this epoch's train_feed calls."""
        return {}


@register_batcher("general")
class GeneralBatcher(Batcher):
    """(user, target) rows; train negatives sampled on device; dev/test use
    logged candidate lists [target | 99 negs] or the full catalog
    (test_all). Parity: reference GeneralModel.Dataset
    (src/models/BaseModel.py:191-214)."""

    def build(self):
        df = self._rows()
        self.n = len(df)
        self.arrays["user_id"] = df["user_id"].to_numpy().astype(np.int32)
        self.arrays["target_item"] = df["item_id"].to_numpy().astype(np.int32)
        self._extra_arrays(df)
        self.test_all = bool(getattr(self.model, "test_all", 0)) and self.phase != "train"
        if self.phase == "train":
            self.arrays["_clicked"] = self.corpus.clicked_matrix(include_residual=False)
            self.num_neg = self.model.num_neg if getattr(self.model, "train_with_neg", True) else 0
        elif not self.test_all:
            neg = np.stack(df["neg_items"].to_list()).astype(np.int32)
            self.arrays["neg_items"] = neg
        else:
            # full-catalog eval: mask train+residual clicked items
            # (reference BaseRunner.py:244-251)
            self.arrays["_clicked_all"] = self.corpus.clicked_matrix(include_residual=True)

    def _rows(self):
        """The phase's rows this batcher serves."""
        return self.corpus.data_df[self.phase]

    def _extra_arrays(self, df) -> None:
        """Per-row arrays a subclass adds beside user_id / target_item."""

    def train_feed(self, arrays, idx, gen):
        users = arrays["user_id"][idx]
        target = arrays["target_item"][idx]
        if self.num_neg > 0:
            if "_ep_neg_items" in arrays:  # epoch_arrays-hoisted lane
                neg = arrays["_ep_neg_items"][idx]
            else:
                neg = sampling.sample_negatives(
                    gen, users, arrays["_clicked"], self.num_neg, self.corpus.n_items)
            item_ids = torch.cat([target[:, None], neg], dim=1)
        else:  # self-supervised models: positives only
            item_ids = target[:, None]
        return {"user_id": users, "item_id": item_ids, "batch_size": users.shape[0]}

    def eval_feed(self, arrays, idx, cands=None):
        users = arrays["user_id"][idx]
        target = arrays["target_item"][idx]
        if self.test_all:
            # candidates = the whole catalog [0..n_items); item 0 (pad) and
            # every train+residual clicked item are masked by the runner;
            # the target's catalog copy is also clicked (it sits in
            # residual_clicked_set), so it never double-counts. The
            # [B, n_items] candidate matrix is an `expand` VIEW of one
            # arange row: catalog-protocol models never read it, and it
            # costs no memory until a model gathers through it.
            if cands is None:
                cands = torch.arange(self.corpus.n_items, device=users.device)[None, :] \
                    .expand(users.shape[0], self.corpus.n_items)
            feed = {
                "user_id": users,
                "item_id": cands,
                "_clicked_rows": arrays["_clicked_all"][users],
                "_target": target,
            }
        else:
            item_ids = torch.cat([target[:, None], arrays["neg_items"][idx]], dim=1)
            feed = {"user_id": users, "item_id": item_ids}
        feed["batch_size"] = users.shape[0]
        return feed


@register_batcher("ctr")
class CTRBatcher(Batcher):
    """Pointwise rows: item_id [B, 1], label [B]; no negative sampling.
    Parity: reference CTRModel.Dataset (BaseModel.py:276-288)."""

    def build(self):
        df = self._df = self._rows()
        self.n = len(df)
        self.arrays["user_id"] = df["user_id"].to_numpy().astype(np.int32)
        self.arrays["target_item"] = df["item_id"].to_numpy().astype(np.int32)
        self.arrays["label"] = df["label"].to_numpy().astype(np.float32)

    def _rows(self):
        """The phase's rows this batcher serves."""
        return self.corpus.data_df[self.phase]

    def _feed(self, arrays, idx):
        users = arrays["user_id"][idx]
        return {
            "user_id": users,
            "item_id": arrays["target_item"][idx][:, None],
            "label": arrays["label"][idx],
            "batch_size": users.shape[0],
        }

    def train_feed(self, arrays, idx, gen):
        return self._feed(arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return self._feed(arrays, idx)


def pad_lists(lists, width: int) -> np.ndarray:
    """[n, width] int32 of the 1-D arrays `lists`, each cut to `width` and
    left-aligned, pad 0; one flat scatter, no per-row loop."""
    n = len(lists)
    lens = np.fromiter((len(x) for x in lists), dtype=np.int64, count=n)
    out = np.zeros((n, width), dtype=np.int32)
    if lens.sum():
        flat = np.concatenate([np.asarray(x, dtype=np.int64) for x in lists])
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        keep = cols < width
        out[rows[keep], cols[keep]] = flat[keep]
    return out


@register_batcher("impression")
class ImpressionBatcher(Batcher):
    """Logged pos/neg lists padded to the phase's caps (port of
    rechorus_tpu/data/batching.py:446-541); item_id = [pos_pad | neg_pad],
    target = +1 valid positive / 0 valid negative / -1 pad (reference
    ImpressionModel.Dataset, BaseImpressionModel.py:154-211, and
    ImpressionRunner.fit's labels, :187-190).

    --test_all (evaluation): the negative block is the WHOLE catalog,
    item_id = [pos_pad | 0..n_items-1] (catalog column j is item j), with
    the user's positively clicked items of every split, id 0 and the pad
    positives at target -1; neg_num is the row's count of valid catalog
    candidates, n_items - 1 - #clicked. This is the masking the reference
    intends at ImpressionRunner.py:141-149 (its own path returns {})."""

    def _source_df(self):
        return self.corpus.data_df[self.phase]

    def build(self):
        df = self._source_df()
        self._df = df
        self.n = len(df)
        self.test_all = bool(getattr(self.model, "test_all", 0)) and self.phase != "train"
        if self.phase == "train":
            self.pos_len = self.model.train_max_pos_item
            self.neg_len = self.model.train_max_neg_item
        else:
            self.pos_len = self.model.test_max_pos_item
            self.neg_len = self.model.test_max_neg_item
        self.arrays["user_id"] = df["user_id"].to_numpy().astype(np.int32)
        self.arrays["pos_items"] = pad_lists(df["pos_items"].to_list(), self.pos_len)
        self.arrays["pos_num"] = np.minimum(df["pos_num"].to_numpy(), self.pos_len).astype(np.int32)
        if self.test_all:
            self.neg_len = self.corpus.n_items
            clicked = self.corpus.pos_clicked_matrix()
            self.arrays["_clicked_rows"] = clicked
            # each clicked id (unique per user) masks one catalog column
            cnt = (clicked > 0).sum(axis=1).astype(np.int64)
            self.arrays["neg_num"] = (self.corpus.n_items - 1 - cnt[self.arrays["user_id"]]).astype(np.int32)
        else:
            self.arrays["neg_items"] = pad_lists(df["neg_items"].to_list(), self.neg_len)
            self.arrays["neg_num"] = np.minimum(df["neg_num"].to_numpy(), self.neg_len).astype(np.int32)

    def _feed(self, arrays, idx):
        users = arrays["user_id"][idx]
        pos = arrays["pos_items"][idx]
        pos_num, neg_num = arrays["pos_num"][idx], arrays["neg_num"][idx]
        dev = users.device
        pos_valid = torch.arange(self.pos_len, device=dev)[None, :] < pos_num[:, None]
        B = users.shape[0]
        if self.test_all:
            N = self.corpus.n_items
            catalog = torch.arange(N, device=dev)[None, :].expand(B, N)
            clicked = arrays["_clicked_rows"][users]                       # [B, M]
            cl = torch.zeros((B, N), dtype=torch.bool, device=dev)
            cl[torch.arange(B, device=dev)[:, None], clicked] = True
            cat_valid = (torch.arange(N, device=dev)[None, :] > 0) & ~cl
            item_ids = torch.cat([pos, catalog], dim=1)
            neg_valid = cat_valid
        else:
            item_ids = torch.cat([pos, arrays["neg_items"][idx]], dim=1)
            neg_valid = torch.arange(self.neg_len, device=dev)[None, :] < neg_num[:, None]
        target = torch.cat([torch.where(pos_valid, 1.0, -1.0), torch.where(neg_valid, 0.0, -1.0)], dim=1)
        return {"user_id": users, "item_id": item_ids, "target": target,
                "pos_num": pos_num, "neg_num": neg_num, "batch_size": B}

    def train_feed(self, arrays, idx, gen):
        return self._feed(arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return self._feed(arrays, idx)


@register_batcher("impression_seq")
class ImpressionSeqBatcher(ImpressionBatcher):
    """+ the dual positive / negative history arrays (port of
    rechorus_tpu/data/batching.py:544-573; reference
    BaseImpressionModel.py:237-253); keeps the requests with position > 0,
    as SequentialModel does."""

    HISTORY_KEYS = ("history_items", "history_times", "lengths",
                    "neg_history_items", "neg_history_times", "neg_lengths")

    def _source_df(self):
        df = self.corpus.data_df[self.phase]
        return df[df["position"].to_numpy() > 0].reset_index(drop=True)

    def build(self):
        super().build()
        his = self.corpus.dual_history_arrays(self._df, self.model.history_max)
        self.arrays.update(zip(self.HISTORY_KEYS, his))

    def _feed(self, arrays, idx):
        feed = super()._feed(arrays, idx)
        for k in self.HISTORY_KEYS:
            feed[k] = arrays[k][idx]
        return feed


RERANK_TEST_ALL_ERROR = "--test_all is not defined for re-ranking models; drop the flag"


def ranker_features(ranker, feed, his_v: bool) -> dict:
    """The first stage's keys of a re-rank feed from `ranker` (an
    `<X>Impression` model) on `feed`: 'scores' (the pads at -inf),
    'position' (each candidate's rank by score, ties in column order: both
    sorts are stable, as jnp.argsort is), 'padding_mask', 'u_v', 'i_v' and,
    with `his_v`, the ranker's item vectors of the positive history (the
    history ids scored as candidates)."""
    out = ranker(feed, training=False)
    valid = feed["target"] != -1
    scores = torch.where(valid, out["prediction"], float("-inf"))
    order = torch.argsort(-scores, dim=1, stable=True)
    keys = {"scores": scores, "position": torch.argsort(order, dim=1, stable=True),
            "padding_mask": ~valid, "u_v": out["u_v"], "i_v": out["i_v"]}
    if his_v:
        keys["his_v"] = ranker({**feed, "item_id": feed["history_items"]}, training=False)["i_v"]
    return keys


class _RerankFeeds:
    """The re-rank batchers' first stage (port of rechorus_tpu/data/
    batching.py:576-684): the frozen ranker, `<ranker_name>Impression`
    loaded by `models/reranker/_loader.load_ranker` on the runner's device,
    runs in eval mode under no_grad inside every feed (the reference runs
    it in its DataLoader's collate, BaseRerankerModel.py:70-84). Under
    --tuneranker 1 the model runs the ranker itself (RerankModel.
    rerank_feed) and the feeds carry the plain impression keys."""

    his_v = False

    def build(self):
        if getattr(self.model, "test_all", 0):
            # re-rankers score a LOGGED candidate list (position embeddings
            # sized by the caps); a full-catalog candidate axis has no
            # meaning here
            raise ValueError(RERANK_TEST_ALL_ERROR)
        super().build()
        from rechorus_tpu_torch.models.reranker._loader import load_ranker

        self.tuneranker = bool(getattr(self.model, "tuneranker", 0))
        self.ranker = load_ranker(self.args, self.corpus,
                                  device_of_gpu_flag(getattr(self.args, "gpu", "0")))

    def post_init_state(self, state):
        """--tuneranker 1: the model's `ranker_module`, just drawn at random
        by init_state, takes the loaded ranker's parameters and buffers (the
        reference un-freezes the loaded ranker in place,
        BaseRerankerModel.py:58-66). Called by BaseRunner.init_state."""
        if not self.tuneranker:
            return state
        module = state.model.ranker_module
        loaded = self.ranker.state_dict()
        if module.state_dict().keys() != loaded.keys():
            raise ValueError("--tuneranker: loaded ranker params do not match the "
                             "ranker_module subtree (config drift between the ranker "
                             "checkpoint and --ranker_config_file?)")
        module.load_state_dict(loaded)
        return state

    def _feed(self, arrays, idx):
        feed = super()._feed(arrays, idx)
        if self.tuneranker:
            return feed
        with torch.no_grad():
            feed.update(ranker_features(self.ranker.eval(), feed, self.his_v))
        return feed


@register_batcher("rerank")
class RerankBatcher(_RerankFeeds, ImpressionBatcher):
    """Impression feeds + the frozen ranker's outputs."""


@register_batcher("rerank_seq")
class RerankSeqBatcher(_RerankFeeds, ImpressionSeqBatcher):
    """Impression-with-history feeds + the frozen ranker's outputs and its
    item vectors of the positive history ('his_v')."""

    his_v = True


def _add_situation(batcher, df):
    """Pack per-row situation features into cat / float blocks."""
    from rechorus_tpu_torch.data.context import is_categorical

    situ = list(batcher.corpus.situation_feature_names)
    cat_cols = [c for c in situ if is_categorical(c)]
    flt_cols = [c for c in situ if not is_categorical(c)]
    if cat_cols:
        batcher.arrays["situ_cat"] = df[cat_cols].to_numpy().astype(np.int32)
    if flt_cols:
        batcher.arrays["situ_float"] = df[flt_cols].to_numpy().astype(np.float32)


def _situ_feed(feed, arrays, idx):
    for k in ("situ_cat", "situ_float"):
        if k in arrays:
            feed[k] = arrays[k][idx]
    return feed


@register_batcher("context")
class ContextBatcher(GeneralBatcher):
    """General top-k feeds + the situation blocks; the user/item feature
    matrices are the model's buffers (see models/base._ContextFields)."""

    def _extra_arrays(self, df) -> None:
        _add_situation(self, df)

    def train_feed(self, arrays, idx, gen):
        return _situ_feed(super().train_feed(arrays, idx, gen), arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return _situ_feed(super().eval_feed(arrays, idx, cands), arrays, idx)


@register_batcher("context_ctr")
class ContextCTRBatcher(CTRBatcher):
    def build(self):
        super().build()
        _add_situation(self, self._df)

    def train_feed(self, arrays, idx, gen):
        return _situ_feed(super().train_feed(arrays, idx, gen), arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return _situ_feed(super().eval_feed(arrays, idx, cands), arrays, idx)


@register_batcher("sequential")
class SequentialBatcher(GeneralBatcher):
    """Adds history_items / history_times / lengths to every feed and keeps
    only the rows with position > 0. Parity: reference
    SequentialModel.Dataset (BaseModel.py:226-245). Under
    `--host_shard_input` the three history arrays are `LazyRows`, each
    row range built once for the three."""

    HISTORY_KEYS = ("history_items", "history_times", "lengths")

    def _rows(self):
        df = self.corpus.data_df[self.phase]
        self._df = df[df["position"].to_numpy() > 0].reset_index(drop=True)
        return self._df

    def _extra_arrays(self, df) -> None:
        H = self.model.history_max
        if not getattr(self.args, "host_shard_input", 0):
            self.arrays.update(zip(self.HISTORY_KEYS, self.corpus.history_arrays(df, H)))
            return
        cache = {}

        def part(lo, hi, j):
            # the three keys ask for the same ranges: build each once, and
            # drop it after its third read
            ent = cache.get((lo, hi))
            if ent is None:
                ent = cache[(lo, hi)] = [self.corpus.history_arrays(df.iloc[lo:hi], H), 0]
            ent[1] += 1
            if ent[1] >= 3:
                cache.pop((lo, hi), None)
            return ent[0][j]

        n = len(df)
        for j, (key, shape, dt) in enumerate(zip(self.HISTORY_KEYS, ((n, H), (n, H), (n,)),
                                                 (np.int32, np.int64, np.int32))):
            self.arrays[key] = LazyRows(shape, dt, lambda lo, hi, j=j: part(lo, hi, j))

    def _with_history(self, feed, arrays, idx):
        for k in self.HISTORY_KEYS:
            feed[k] = arrays[k][idx]
        return feed

    def train_feed(self, arrays, idx, gen):
        return self._with_history(super().train_feed(arrays, idx, gen), arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return self._with_history(super().eval_feed(arrays, idx, cands), arrays, idx)


def _maybe_neg_history(batcher, feed, gen, rounds: int = 4):
    """DIEN's sampled negative history for its auxiliary loss (port of
    rechorus_tpu/data/batching.py:242-255): uniform ids in [1, n_items)
    drawn from the step's generator, each avoiding the positive at its slot
    within `rounds` resampling rounds (reference DIEN.py:195-205 samples
    per epoch on the host)."""
    if getattr(batcher.model, "alpha_aux", 0) <= 0 or "history_items" not in feed:
        return feed
    hist = feed["history_items"]
    cand = torch.randint(1, batcher.corpus.n_items, (rounds + 1,) + tuple(hist.shape), generator=gen,
                         device=hist.device, dtype=hist.dtype)
    feed["history_neg_items"] = sampling.first_accepted(cand, cand == hist[None])
    return feed


def _history_situ(batcher, df) -> np.ndarray:
    """[n, H, F_s] situation values at each history step, categorical
    columns first (the order `group_embeddings` reads): float32 when a
    situation feature is a float one, else int32 (port of
    rechorus_tpu/data/batching.py:257-268)."""
    from rechorus_tpu_torch.data.context import is_categorical

    situ = list(batcher.corpus.situation_feature_names)
    raw = batcher.corpus.history_situ_arrays(df, batcher.model.history_max)
    order = [i for i, c in enumerate(situ) if is_categorical(c)] + \
        [i for i, c in enumerate(situ) if not is_categorical(c)]
    return raw[:, :, order].astype(np.int32 if all(is_categorical(c) for c in situ) else np.float32)


@register_batcher("context_seq")
class ContextSeqBatcher(SequentialBatcher):
    """Sequential top-k feeds + the situation blocks, the situations of the
    history steps with --add_historical_situations 1, and DIEN's negative
    history in training (port of rechorus_tpu/data/batching.py:383-411).
    The history items' features are gathered in the model from its feature
    buffers by id (the reference precomputes history_<feature> columns,
    BaseContextModel.py:110-124)."""

    def _extra_arrays(self, df) -> None:
        super()._extra_arrays(df)
        _add_situation(self, df)
        if getattr(self.model, "add_historical_situations", 0):
            self.arrays["history_situ"] = _history_situ(self, df)

    def _context(self, feed, arrays, idx):
        feed = _situ_feed(feed, arrays, idx)
        if "history_situ" in arrays:
            feed["history_situ"] = arrays["history_situ"][idx]
        return feed

    def train_feed(self, arrays, idx, gen):
        return _maybe_neg_history(self, self._context(super().train_feed(arrays, idx, gen), arrays, idx), gen)

    def eval_feed(self, arrays, idx, cands=None):
        return self._context(super().eval_feed(arrays, idx, cands), arrays, idx)


@register_batcher("context_seq_ctr")
class ContextSeqCTRBatcher(CTRBatcher):
    """Pointwise CTR rows with position > 0 + their history arrays, the
    situation blocks and historical situations (port of
    rechorus_tpu/data/batching.py:414-446; reference ContextSeqCTRModel.
    Dataset, BaseContextModel.py:144-166)."""

    KEYS = ("history_items", "history_times", "lengths", "history_situ", "situ_cat", "situ_float")

    def _rows(self):
        df = self.corpus.data_df[self.phase]
        return df[df["position"].to_numpy() > 0].reset_index(drop=True)

    def build(self):
        super().build()
        df = self._df
        his = self.corpus.history_arrays(df, self.model.history_max)
        self.arrays.update(zip(SequentialBatcher.HISTORY_KEYS, his))
        _add_situation(self, df)
        if getattr(self.model, "add_historical_situations", 0):
            self.arrays["history_situ"] = _history_situ(self, df)

    def _feed(self, arrays, idx):
        feed = super()._feed(arrays, idx)
        for k in self.KEYS:
            if k in arrays:
                feed[k] = arrays[k][idx]
        return feed

    def train_feed(self, arrays, idx, gen):
        return _maybe_neg_history(self, self._feed(arrays, idx), gen)


@register_batcher("kda")
class KDABatcher(SequentialBatcher):
    """KDA feeds (port of rechorus_tpu/data/batching.py:941-1056):
    sequential feeds plus the per-candidate relation-value entities
    (item_val [B, C, R]), the log-normalized history time deltas, and in
    training a DistMult KG batch of one triplet per row with mixed
    head/tail corruption.

    Parity: reference KDA.Dataset (KDA.py:192-263). The reference samples
    the epoch's KG rows and negatives on the host (actions_before_epoch);
    here `epoch_arrays` draws them once per epoch on the device, from the
    epoch's generator.
    """

    def build(self):
        super().build()
        self.arrays["time"] = self._df["time"].to_numpy().astype(np.int64)
        self.arrays["_item_val"] = self.corpus.item_value_matrix()
        if self.phase == "train":
            rel = self.corpus.relation_df
            self.arrays["kg_head"] = rel["head"].to_numpy().astype(np.int32)
            self.arrays["kg_tail"] = rel["tail"].to_numpy().astype(np.int32)
            self.arrays["kg_relation"] = rel["relation"].to_numpy().astype(np.int32)
            self.arrays["_triplet_keys"] = self.corpus.member_table()
            mat, lens = self.corpus.share_attr_matrix()
            self.arrays["_share_mat"] = mat
            self.arrays["_share_len"] = lens

    def _common(self, feed, arrays, idx):
        feed["item_val"] = arrays["_item_val"][feed["item_id"]]  # [B, C, R]
        dt = (arrays["time"][idx][:, None] - feed["history_times"]).to(torch.float32)
        # norm_time (reference KDAReader.py:33-37)
        feed["history_delta_t"] = torch.clamp_min(torch.log2(dt / self.model.t_scalar + 1e-6), 0.0)
        return feed

    def _sample_kg_block(self, arrays, gen, M: int, rounds: int = 8):
        """One DistMult KG row and its corruptions per train row, for M rows
        at once: {head_id, tail_id: [M, 1 + num_neg], relation_id,
        value_id: [M]}. Attribute rows take a random item sharing the
        attribute as their tail. A corrupted head or tail is redrawn while
        it forms a known triplet (`kg.is_member`), all rounds drawn at once
        ([rounds + 1, M, num_neg]) and the first accepted kept."""
        n_items = self.corpus.n_items
        n_rel, n_ent = self.corpus.n_relations, self.corpus.n_entities
        keys_arr = arrays["_triplet_keys"]
        N = self.model.num_neg
        dev = keys_arr.device
        tri = torch.randint(0, len(self.arrays["kg_head"]), (M,), generator=gen, device=dev)
        h, t, r = arrays["kg_head"][tri], arrays["kg_tail"][tri], arrays["kg_relation"][tri]
        is_attr = t >= n_items
        val = torch.where(is_attr, t, 0)
        # attr rows: the tail becomes a random item SHARING the attribute
        row = (t - n_items).clamp(0, arrays["_share_mat"].shape[0] - 1)
        j = torch.randint(0, 1 << 30, (M,), generator=gen, device=dev) \
            % arrays["_share_len"][row].clamp_min(1)
        t_item = torch.where(is_attr, arrays["_share_mat"][row, j], t)

        def draw():
            return torch.randint(1, n_items, (rounds + 1, M, N), generator=gen, device=dev)

        # negative heads: (h', r, tail-or-value) must not exist
        probe_t = torch.where(is_attr, val, t_item)
        cand = draw()
        neg_head_cand = sampling.first_accepted(cand, kg_ops.is_member(
            keys_arr, cand, r[None, :, None], probe_t[None, :, None], n_rel, n_ent))
        # negative tails: item-item rows probe (h, r, t'); attribute rows
        # probe (t', r, value) -- the corrupted item must not share it
        cand = draw()
        bad = torch.where(
            is_attr[None, :, None],
            kg_ops.is_member(keys_arr, cand, r[None, :, None], val[None, :, None], n_rel, n_ent),
            kg_ops.is_member(keys_arr, h[None, :, None], r[None, :, None], cand, n_rel, n_ent))
        neg_tail_cand = sampling.first_accepted(cand, bad)
        choose_head = torch.rand((M, N), generator=gen, device=dev) < self.model.neg_head_p
        neg_heads = torch.where(choose_head, neg_head_cand, h[:, None])
        neg_tails = torch.where(choose_head, t_item[:, None], neg_tail_cand)
        return {
            "head_id": torch.cat([h[:, None], neg_heads], dim=1),
            "tail_id": torch.cat([t_item[:, None], neg_tails], dim=1),
            "relation_id": r,
            "value_id": val,
        }

    def epoch_arrays(self, arrays, gen):
        """The KG block of every train row, drawn once per epoch (the JAX
        package hoists it the same way); the rec negatives stay per step."""
        if self.phase != "train":
            return {}
        return {"_ep_kg_" + k: v for k, v in self._sample_kg_block(arrays, gen, self.n).items()}

    def train_feed(self, arrays, idx, gen):
        """Needs the epoch's KG block in `arrays` (`epoch_arrays`, which
        `BaseRunner.fit` merges before the steps)."""
        feed = self._common(super().train_feed(arrays, idx, gen), arrays, idx)
        for k in ("head_id", "tail_id", "relation_id", "value_id"):
            feed[k] = arrays["_ep_kg_" + k][idx]
        return feed

    def eval_feed(self, arrays, idx, cands=None):
        return self._common(super().eval_feed(arrays, idx, cands), arrays, idx)


@register_batcher("tisas")
class TiSASBatcher(SequentialBatcher):
    """Sequential feeds + each row's user's minimum positive time gap
    (reference TiSASRec.py:48-53 takes it over the user's whole
    timeline), 0xFFFFFFFF for a user with none. One sort of all
    interactions by (user, time) and one grouped minimum, where the JAX
    package loops over the users."""

    def build(self):
        super().build()
        u = self.corpus.all_df["user_id"].to_numpy(np.int64)
        t = self.corpus.all_df["time"].to_numpy(np.int64)
        order = np.lexsort((t, u))
        u, t = u[order], t[order]
        gap = np.diff(t)
        ok = (u[1:] == u[:-1]) & (gap > 0)
        mins = np.full(int(u.max(initial=0)) + 1, 0xFFFFFFFF, dtype=np.int64)
        np.minimum.at(mins, u[1:][ok], gap[ok])
        self.arrays["user_min_intervals"] = mins[self._df["user_id"].to_numpy(np.int64)]

    def train_feed(self, arrays, idx, gen):
        feed = super().train_feed(arrays, idx, gen)
        feed["user_min_intervals"] = arrays["user_min_intervals"][idx]
        return feed

    def eval_feed(self, arrays, idx, cands=None):
        feed = super().eval_feed(arrays, idx, cands)
        feed["user_min_intervals"] = arrays["user_min_intervals"][idx]
        return feed


def beta_sample(gen: torch.Generator, a: float, b: float, n: int) -> torch.Tensor:
    """[n] draws of Beta(a, b) from `gen`, as Ga / (Ga + Gb) of two
    standard Gamma draws (torch.distributions.Beta samples from the global
    generator only)."""
    dev = gen.device
    ga = torch._standard_gamma(torch.full((n,), float(a), device=dev), generator=gen)
    gb = torch._standard_gamma(torch.full((n,), float(b), device=dev), generator=gen)
    return ga / (ga + gb)


def beta_augment(gen: torch.Generator, hist, lengths, a: float, b: float, mask_token: int):
    """One augmented view of a padded history batch [B, H]: per row, with
    probability 1/2 the mask op or the reorder op, each over the VALID
    prefix with a Beta(a, b) ratio (reference ContraRec.Dataset,
    ContraRec.py:106-140; JAX `_beta_augment`). The mask op replaces
    floor(len * ratio) uniformly chosen valid items by `mask_token`; the
    reorder op shuffles a random contiguous span of floor(len * ratio)
    items. Every draw comes from `gen`."""
    B, H = hist.shape
    dev = hist.device
    pos = torch.arange(H, device=dev)[None, :]
    valid = pos < lengths[:, None]
    ratio = beta_sample(gen, a, b, B)
    k = torch.floor(lengths * ratio).long()                            # [B]
    # mask op: the k valid positions of lowest random score
    scores = torch.rand((B, H), generator=gen, device=dev) + (~valid) * 2.0
    rank = torch.argsort(torch.argsort(scores, dim=-1), dim=-1)
    masked = torch.where((rank < k[:, None]) & valid, mask_token, hist)
    # reorder op: random sort keys inside [start, start + k), positions outside
    start = torch.floor(torch.rand(B, generator=gen, device=dev)
                        * (lengths - k + 1).float()).long()
    in_span = (pos >= start[:, None]) & (pos < (start + k)[:, None]) & valid
    rand_key = start[:, None] + torch.rand((B, H), generator=gen, device=dev) * k[:, None]
    order = torch.argsort(torch.where(in_span, rand_key, pos.float()), dim=-1)
    reordered = hist.gather(1, order)
    choose_mask = torch.rand(B, generator=gen, device=dev) > 0.5
    return torch.where(choose_mask[:, None], masked, reordered)


def _two_views(batcher, feed, gen, mask_token: int):
    """The two augmented history views of a train feed (ContraRec and
    ContraKDA's context-context contrast)."""
    a, b = float(batcher.model.beta_a), float(batcher.model.beta_b)
    for key in ("history_items_a", "history_items_b"):
        feed[key] = beta_augment(gen, feed["history_items"], feed["lengths"], a, b, mask_token)
    return feed


@register_batcher("contra")
class ContraBatcher(SequentialBatcher):
    """Sequential feeds + two augmented history views for ContraRec; the
    mask token is item_num, one id past the catalog."""

    def train_feed(self, arrays, idx, gen):
        return _two_views(self, super().train_feed(arrays, idx, gen), gen, self.corpus.n_items)


@register_batcher("contra_kda")
class ContraKDABatcher(KDABatcher):
    """KDA feeds + two augmented history views for ContraKDA. Masked
    positions become pad id 0 (the entity table has no spare mask row):
    item-dropout views."""

    def train_feed(self, arrays, idx, gen):
        return _two_views(self, super().train_feed(arrays, idx, gen), gen, 0)


# ---------------------------------------------------------------------------
# Knowledge-aware batchers
# ---------------------------------------------------------------------------


def _kg_corruption(batcher, arrays, idx, gen, swap_feed: bool = False):
    """The 4-column TransE corruption (h, h, h, h') x (t, t, t', t) of the KG
    rows `idx`, negatives rejection-sampled on the device against the
    triplet set (`kg.sample_kg_negatives`; reference CFKG.Dataset /
    Chorus.Dataset.actions_before_epoch). `swap_feed` reverses head and
    tail in the FEED (Chorus stage 1 trains the inverse relations,
    reference Chorus.py:205-210). Needs `batcher.kg_neg_hi`, the bound of
    both negative draws."""
    h, r, t = arrays["kg_head"][idx], arrays["kg_relation"][idx], arrays["kg_tail"][idx]
    neg_heads, neg_tails = kg_ops.sample_kg_negatives(
        gen, h, r, t, arrays["_triplet_keys"], batcher.corpus.n_relations,
        batcher.corpus.n_entities, hi_tail=batcher.kg_neg_hi, hi_head=batcher.kg_neg_hi)
    head_id = torch.stack([h, h, h, neg_heads], dim=1)
    tail_id = torch.stack([t, t, neg_tails, t], dim=1)
    if swap_feed:
        head_id, tail_id = tail_id, head_id
    return {"head_id": head_id, "tail_id": tail_id, "relation_id": r[:, None].expand(-1, 4),
            "batch_size": h.shape[0]}


@register_batcher("cfkg")
class CFKGBatcher(Batcher):
    """CFKG: train rows = KG triplets + 'buy' interactions (relation 0);
    eval = the user as head, relation 0, the candidates as tails. Entity
    indexing in the FEED: users first, then entities (the + n_users
    offsets are applied here, reference CFKG.Dataset._get_feed_dict). The
    feeds carry no `item_id`.

    As in the JAX package, both negative draws of a relation > 0 row are
    uniform in U[1, n_entities) (the reference draws its first neg_tail
    from U[1, n_items) and resamples in U[1, n_entities), the distribution
    its loop converges to).
    """

    def build(self):
        df = self.corpus.data_df[self.phase]
        if self.phase == "train":
            rel = self.corpus.relation_df
            self.arrays["kg_head"] = np.concatenate(
                [rel["head"].to_numpy(), df["user_id"].to_numpy()]).astype(np.int32)
            self.arrays["kg_tail"] = np.concatenate(
                [rel["tail"].to_numpy(), df["item_id"].to_numpy()]).astype(np.int32)
            self.arrays["kg_relation"] = np.concatenate(
                [rel["relation"].to_numpy(), np.zeros(len(df))]).astype(np.int32)
            self.arrays["_triplet_keys"] = self.corpus.member_table()
            self.arrays["_clicked"] = self.corpus.clicked_matrix(include_residual=False)
            self.n = len(self.arrays["kg_head"])
        else:
            self.n = len(df)
            self.arrays["user_id"] = df["user_id"].to_numpy().astype(np.int32)
            self.arrays["target_item"] = df["item_id"].to_numpy().astype(np.int32)
            self.test_all = bool(getattr(self.model, "test_all", 0))
            if not self.test_all:
                self.arrays["neg_items"] = np.stack(df["neg_items"].to_list()).astype(np.int32)
            else:
                self.arrays["_clicked_all"] = self.corpus.clicked_matrix(include_residual=True)

    def train_feed(self, arrays, idx, gen):
        h, r, t = arrays["kg_head"][idx], arrays["kg_relation"][idx], arrays["kg_tail"][idx]
        is_buy = r == 0
        B, dev = h.shape[0], h.device
        n_users, n_items = self.corpus.n_users, self.corpus.n_items
        n_entities, n_rel = self.corpus.n_entities, self.corpus.n_relations
        clicked, keys = arrays["_clicked"], arrays["_triplet_keys"]

        def in_clicked(users, cand):
            return (cand[..., None] == clicked[users.clamp(0, n_users - 1)]).any(-1)

        def draw(buy_hi):
            # 8 resampling rounds, all drawn at once; a buy row's draw folds
            # into [1, buy_hi)
            raw = torch.randint(1, n_entities, (9, B), generator=gen, device=dev)
            return torch.where(is_buy, 1 + (raw - 1) % (buy_hi - 1), raw)

        # neg tail: buy rows avoid the head user's clicked items; KG rows
        # avoid existing (h, r, t') triplets
        cand = draw(n_items)
        neg_tails = sampling.first_accepted(cand, torch.where(
            is_buy, in_clicked(h[None].expand_as(cand), cand),
            kg_ops.is_member(keys, h[None], r[None], cand, n_rel, n_entities)))
        # neg head: buy rows take a user u' whose clicked set excludes t; KG
        # rows avoid (h', r, t)
        cand = draw(n_users)
        neg_heads = sampling.first_accepted(cand, torch.where(
            is_buy, in_clicked(cand, t[None].expand_as(cand)),
            kg_ops.is_member(keys, cand, r[None], t[None], n_rel, n_entities)))
        head_id = torch.stack([h, h, h, neg_heads], dim=1)
        tail_id = torch.stack([t, t, neg_tails, t], dim=1) + n_users
        head_id = torch.where((r > 0)[:, None], head_id + n_users, head_id)
        return {"head_id": head_id, "tail_id": tail_id, "relation_id": r[:, None].expand(B, 4),
                "batch_size": B}

    def eval_feed(self, arrays, idx, cands=None):
        users = arrays["user_id"][idx]
        target = arrays["target_item"][idx]
        B = users.shape[0]
        if getattr(self, "test_all", False):
            tails = cands if cands is not None else torch.arange(
                self.corpus.n_items, device=users.device)[None, :].expand(B, self.corpus.n_items)
            feed = {"_clicked_rows": arrays["_clicked_all"][users], "_target": target}
        else:
            tails = torch.cat([target[:, None], arrays["neg_items"][idx]], dim=1)
            feed = {}
        feed.update({"head_id": users[:, None].expand(tails.shape),
                     "tail_id": tails + self.corpus.n_users,
                     "relation_id": torch.zeros_like(tails), "batch_size": B})
        return feed


@register_batcher("slrc")
class SLRCBatcher(SequentialBatcher):
    """Sequential feeds + the [B, C, R] `relational_interval` of every
    candidate (`kg.relational_intervals`; reference SLRCPlus.Dataset's
    Python loops). The sampled eval candidates are fixed, so their
    intervals are computed once at build; in training the target
    column's are, and the sampled negatives' are computed per step. The
    build computes on the runner's device (`--gpu`), 1024 rows at a time."""

    include_repeat = True

    def build(self):
        super().build()
        self.arrays["time"] = self._df["time"].to_numpy().astype(np.int64)
        self.arrays["_triplet_keys"] = self.corpus.member_table()
        if self.phase != "train" and not self.test_all:
            items = np.concatenate([self.arrays["target_item"][:, None], self.arrays["neg_items"]],
                                   axis=1)
            self.arrays["relational_interval"] = self._precompute_intervals(items)
        elif self.phase == "train":
            self.arrays["_target_interval"] = self._precompute_intervals(
                self.arrays["target_item"][:, None])

    def _interval_fn(self, history, his_times, now, items, keys):
        return kg_ops.relational_intervals(
            history, his_times, now, items, keys, self.corpus.n_relations,
            self.corpus.n_entities, float(self.model.time_scalar), self.include_repeat,
            query_relations=self.model.relation_num)

    def _precompute_intervals(self, items: np.ndarray, rows: int = 1024) -> np.ndarray:
        dev = device_of_gpu_flag(getattr(self.args, "gpu", "0"))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).long().to(dev)

        keys = put(self.arrays["_triplet_keys"])
        out = []
        for s in range(0, self.n, rows):
            e = min(s + rows, self.n)
            out.append(self._interval_fn(
                put(self.arrays["history_items"][s:e]), put(self.arrays["history_times"][s:e]),
                put(self.arrays["time"][s:e]), put(items[s:e]), keys).cpu().numpy())
        if not out:
            return np.zeros((0, items.shape[1], self.model.relation_num), np.float32)
        return np.concatenate(out, axis=0)

    def _add_interval(self, feed, arrays, idx):
        if "relational_interval" in arrays:
            feed["relational_interval"] = arrays["relational_interval"][idx]
        else:
            feed["relational_interval"] = self._interval_fn(
                feed["history_items"], feed["history_times"], arrays["time"][idx],
                feed["item_id"], arrays["_triplet_keys"])
        return feed

    def train_feed(self, arrays, idx, gen):
        feed = super().train_feed(arrays, idx, gen)
        if "_target_interval" in arrays:
            neg = self._interval_fn(feed["history_items"], feed["history_times"],
                                    arrays["time"][idx], feed["item_id"][:, 1:],
                                    arrays["_triplet_keys"])
            feed["relational_interval"] = torch.cat([arrays["_target_interval"][idx], neg], dim=1)
            return feed
        return self._add_interval(feed, arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return self._add_interval(super().eval_feed(arrays, idx, cands), arrays, idx)


@register_batcher("chorus")
class ChorusBatcher(SLRCBatcher):
    """Stage 1 train: TransE corruption over the reversed relation
    triplets (`_kg_corruption(swap_feed=True)`); otherwise SLRC+'s feeds
    without the repeat relation, plus each candidate's category_id
    (reference Chorus.Dataset)."""

    include_repeat = False

    def build(self):
        self.kg_train = self.model.stage == 1 and self.phase == "train"
        if self.kg_train:
            rel = self.corpus.relation_df
            self.arrays["kg_head"] = rel["head"].to_numpy().astype(np.int32)
            self.arrays["kg_tail"] = rel["tail"].to_numpy().astype(np.int32)
            self.arrays["kg_relation"] = rel["relation"].to_numpy().astype(np.int32)
            self.arrays["_triplet_keys"] = self.corpus.member_table()
            self.kg_neg_hi = self.corpus.n_items
            self.n = len(rel)
            return
        super().build()
        cate = np.zeros(self.corpus.n_items, dtype=np.int32)
        col = self.model.category_col
        if col:
            meta = self.corpus.item_meta_df
            cate[meta["item_id"].to_numpy()] = meta[col].to_numpy().astype(np.int32)
        self.arrays["_item2cate"] = cate

    def train_feed(self, arrays, idx, gen):
        if self.kg_train:
            return _kg_corruption(self, arrays, idx, gen, swap_feed=True)
        feed = super().train_feed(arrays, idx, gen)
        feed["category_id"] = arrays["_item2cate"][feed["item_id"]]
        return feed

    def eval_feed(self, arrays, idx, cands=None):
        feed = super().eval_feed(arrays, idx, cands)
        feed["category_id"] = arrays["_item2cate"][feed["item_id"]]
        return feed


@register_batcher("seq_delta")
class SeqDeltaBatcher(SequentialBatcher):
    """Sequential feeds + the log-normalised age of each history item,
    `history_delta_t` = max(log2((t - history_times) / t_scalar + 1e-6), 0)
    in f32 (FourierTA's feeds; port of rechorus_tpu/data/batching.py:
    1152-1171; reference FourierTA.Dataset + KDAReader.norm_time). The
    same term as KDA's, within 2 ulp of the JAX package's on the CPU (its
    XLA division may round differently)."""

    def build(self):
        super().build()
        self.arrays["time"] = self._df["time"].to_numpy().astype(np.int64)

    def _delta(self, feed, arrays, idx):
        dt = (arrays["time"][idx][:, None] - feed["history_times"]).to(torch.float32)
        feed["history_delta_t"] = torch.clamp_min(torch.log2(dt / self.model.t_scalar + 1e-6), 0.0)
        return feed

    def train_feed(self, arrays, idx, gen):
        return self._delta(super().train_feed(arrays, idx, gen), arrays, idx)

    def eval_feed(self, arrays, idx, cands=None):
        return self._delta(super().eval_feed(arrays, idx, cands), arrays, idx)


@register_batcher("s3rec")
class S3RecBatcher(SequentialBatcher):
    """S3Rec's stage-1 train rows are the user sequences cut into
    history_max chunks, with the MIP masking and the SP segment sampling
    drawn on the device from the step's generator (port of
    rechorus_tpu/data/batching.py:1174-1232; reference S3Rec.Dataset,
    S3Rec.py:117-183); stage 2 and every dev / test feed are plain
    sequential."""

    NEG_ROUNDS = 8

    def build(self):
        self.pre_train = self.model.stage == 1 and self.phase == "train"
        if not self.pre_train:
            super().build()
            return
        H = self.model.history_max
        his = self.corpus.user_his
        # users ascending, each user's items in its history order: the JAX
        # package's walk over corpus.user_his
        counts = np.diff(his.offsets)
        items = his.flat[:, 0]
        chunks = np.where(counts > 0, (counts - 1) // H + 1, 0)
        user = np.repeat(np.arange(len(counts)), chunks)
        k = np.arange(len(user)) - np.repeat(np.cumsum(chunks) - chunks, chunks)
        start = his.offsets[user] + k * H
        lens = np.minimum(H, counts[user] - k * H)
        cols = np.arange(H)[None, :]
        rows = np.where(cols < lens[:, None],
                        items[np.minimum(start[:, None] + cols, max(len(items) - 1, 0))], 0)
        self.n = len(rows)
        self.arrays["item_seq"] = rows.astype(np.int32)
        self.arrays["seq_len"] = lens.astype(np.int32)
        self.arrays["long_seq"] = items.astype(np.int32)

    def train_feed(self, arrays, idx, gen):
        if not self.pre_train:
            return super().train_feed(arrays, idx, gen)
        seq, seq_len = arrays["item_seq"][idx], arrays["seq_len"][idx]      # [B, H], [B]
        B, H = seq.shape
        dev = seq.device
        n_items = mask_token = self.corpus.n_items
        pos = torch.arange(H, device=dev)[None, :]
        valid = pos < seq_len[:, None]

        # MIP: mask random valid positions; a negative appears nowhere in the row
        mip_sel = (torch.rand((B, H), generator=gen, device=dev) < self.model.mask_ratio) & valid
        mask_seq = torch.where(mip_sel, mask_token, seq)
        cand = torch.randint(1, n_items, (self.NEG_ROUNDS + 1, B, H), generator=gen, device=dev)
        neg = sampling.first_accepted(cand, (cand[..., None] == seq[None, :, None, :]).any(-1))
        neg_item = torch.where(mip_sel, neg, seq)

        # SP: mask a contiguous segment; the negative segment comes from the
        # long stream of every user's items
        half = torch.clamp_min(seq_len // 2, 1)
        sample_len = 1 + torch.randint(0, 1 << 30, (B,), generator=gen, device=dev) % half
        start = torch.randint(0, 1 << 30, (B,), generator=gen, device=dev) \
            % torch.clamp_min(seq_len - sample_len, 1)
        long_seq = arrays["long_seq"]
        n_long = long_seq.shape[0]
        neg_start = torch.randint(0, 1 << 30, (B,), generator=gen, device=dev) % max(n_long - H, 1)
        in_span = (pos >= start[:, None]) & (pos < (start + sample_len)[:, None]) & valid
        trivial = (seq_len < 2)[:, None]       # length < 2: keep copies (reference :151)
        masked = in_span & ~trivial
        mask_seg_seq = torch.where(masked, mask_token, seq)
        pos_seg = torch.where(in_span | ~valid | trivial, seq, mask_token)
        neg_gathered = long_seq[(neg_start[:, None] + (pos - start[:, None])).clamp(0, n_long - 1)]
        neg_seg = torch.where(masked, neg_gathered, pos_seg)
        return {"mask_seq": mask_seq, "pos_item": seq, "neg_item": neg_item,
                "mask_seg_seq": mask_seg_seq, "pos_seg": pos_seg, "neg_seg": neg_seg,
                "seq_len": seq_len, "batch_size": B}
