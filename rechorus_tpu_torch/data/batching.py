"""Fixed-shape device-resident batch pipelines (port of
rechorus_tpu/data/batching.py:26-38, 83-196).

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

from rechorus_tpu_torch.ops import sampling

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
        int64 there."""
        out = {}
        for k, v in self.arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(device)
        return out

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
        df = self.corpus.data_df[self.phase]
        self.n = len(df)
        self.arrays["user_id"] = df["user_id"].to_numpy().astype(np.int32)
        self.arrays["target_item"] = df["item_id"].to_numpy().astype(np.int32)
        self.test_all = bool(getattr(self.model, "test_all", 0)) and self.phase != "train"
        if self.phase == "train":
            self.arrays["_clicked"] = self.corpus.clicked_matrix(include_residual=False)
            self.num_neg = self.model.num_neg if getattr(self.model, "train_with_neg", True) else 0
        elif not self.test_all:
            neg = np.stack(self.corpus.data_df[self.phase]["neg_items"].to_list()).astype(np.int32)
            self.arrays["neg_items"] = neg
        else:
            # full-catalog eval: mask train+residual clicked items
            # (reference BaseRunner.py:244-251)
            self.arrays["_clicked_all"] = self.corpus.clicked_matrix(include_residual=True)

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
