"""A split's rows as ReChorus's readers and batchers define them, worked
out from the raw (user, item, time) interactions:

- a row's position is the number of the user's interactions before it in
  time, over train and dev together;
- a sequential model trains and evaluates only rows with position > 0,
  each with the user's last `history_max` items before it, oldest first,
  left-aligned and 0-padded;
- a user's clicked ids are the distinct items of its train rows (the
  negatives' exclusion) or of all its rows (the full-catalog masks).
"""
from __future__ import annotations

import numpy as np


class Rows:
    def __init__(self, interactions, sequential: bool, history_max: int = 0):
        self.inter, self.sequential, self.H = interactions, sequential, history_max
        u, t = interactions.user, interactions.time
        order = np.lexsort((t, u))                     # by user, then time
        self.by_user_item = interactions.item[order]
        counts = np.bincount(u, minlength=interactions.n_users)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        position = np.empty(len(u), dtype=np.int64)
        position[order] = np.arange(len(u)) - np.repeat(self.offsets[:-1], counts)
        self.position = position
        tr = ~interactions.is_dev
        self.train_flat, self.train_offsets = self._csr(u[tr], interactions.item[tr])

    def _csr(self, users, items):
        order = np.lexsort((items, users))
        users, items = users[order], items[order]
        keep = np.ones(len(users), dtype=bool)
        keep[1:] = (users[1:] != users[:-1]) | (items[1:] != items[:-1])
        users, items = users[keep], items[keep]
        counts = np.bincount(users, minlength=self.inter.n_users)
        return items, np.concatenate([[0], np.cumsum(counts)])

    def split_rows(self, split: str) -> np.ndarray:
        """Indices into the interactions of the split's rows, in the
        order the batcher serves them."""
        keep = ~self.inter.is_dev if split == "train" else self.inter.is_dev
        idx = np.flatnonzero(keep)
        if self.sequential:
            idx = idx[self.position[idx] > 0]
        return idx

    def fields(self, rows: np.ndarray) -> dict:
        """{"user", "item", and for a sequential model "history" [n, H],
        "length" [n]} of interaction indices `rows`."""
        out = {"user": self.inter.user[rows], "item": self.inter.item[rows]}
        if self.sequential:
            H = self.H
            pos = self.position[rows]
            length = np.minimum(pos, H)
            start = self.offsets[out["user"]] + pos - length
            cols = np.arange(H)
            valid = cols[None, :] < length[:, None]
            src = np.where(valid, start[:, None] + cols[None, :], 0)
            out["history"] = np.where(valid, self.by_user_item[src], 0)
            out["length"] = length
        return out

    def in_train(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """Whether each (users[r], items[r, j]) is a train interaction: a
        lookup in the user's sorted train items, all rows at once."""
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64).reshape(len(users), -1)
        lo = self.train_offsets[users][:, None]
        hi = self.train_offsets[users + 1][:, None]
        # the train items keyed by user, sorted: user * (max item + 1) + item
        span = int(self.inter.item.max()) + 1 if len(self.inter.item) else 1
        owner = np.repeat(np.arange(len(self.train_offsets) - 1), np.diff(self.train_offsets))
        keys = owner * span + self.train_flat
        want = users[:, None] * span + np.clip(items, 0, span - 1)
        at = np.searchsorted(keys, want)
        hit = (at >= lo) & (at < hi)
        hit[hit] = keys[at[hit]] == want[hit]
        return hit & (items >= 0) & (items < span)

    def all_clicked(self, users: np.ndarray) -> np.ndarray:
        """[n, M] 0-padded distinct items of each user's rows."""
        sets = [np.unique(self.by_user_item[self.offsets[u]: self.offsets[u + 1]]) for u in users]
        width = max(1, max(len(s) for s in sets))
        out = np.zeros((len(users), width), dtype=np.int64)
        for r, s in enumerate(sets):
            out[r, :len(s)] = s
        return out
