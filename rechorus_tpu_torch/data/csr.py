"""Compact CSR-backed corpus structures (copy of rechorus_tpu/data/csr.py:
19-137, the parts the BaseReader uses).

Per-user corpus state lives in two numpy arrays (flat values + [n_users+1]
offsets) built by vectorized sort/unique passes; `CSRRows` wraps them in
a read-only Mapping so consumers of the reference's dict contract keep
working.
"""
from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np


class CSRRows(Mapping):
    """Read-only {user -> np.ndarray view of its rows} over CSR storage.

    `flat` is [T] (e.g. sorted clicked item ids) or [T, k]; `offsets` is
    [n_users + 1]. Iteration yields only users with non-empty rows, `get`
    returns a default for empty/out-of-range users.
    """

    __slots__ = ("flat", "offsets")

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = flat
        self.offsets = offsets

    def __getitem__(self, u: int) -> np.ndarray:
        return self.flat[self.offsets[u]: self.offsets[u + 1]]

    def get(self, u, default=()):
        if 0 <= u < len(self.offsets) - 1:
            row = self[u]
            if len(row):
                return row
        return default

    def __contains__(self, u) -> bool:
        return 0 <= u < len(self.offsets) - 1 and self.offsets[u] < self.offsets[u + 1]

    def __iter__(self) -> Iterator[int]:
        counts = np.diff(self.offsets)
        return iter(np.nonzero(counts)[0].tolist())

    def __len__(self) -> int:
        return int((np.diff(self.offsets) > 0).sum())


def pairs_to_csr(users: np.ndarray, values: np.ndarray, n_users: int,
                 unique: bool = False):
    """Group (user, value) pairs into CSR (flat sorted by user, values
    ascending within user; `unique=True` dedups per user)."""
    users = np.asarray(users, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    order = np.lexsort((values, users))
    u, v = users[order], values[order]
    if unique and len(u):
        keep = np.ones(len(u), dtype=bool)
        keep[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
        u, v = u[keep], v[keep]
    counts = np.bincount(u, minlength=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return v, offsets


def csr_fill_matrix(flat: np.ndarray, offsets: np.ndarray, max_len: int,
                    dtype=np.int32) -> np.ndarray:
    """[n_users, max_len] left-aligned padded matrix from CSR (pad 0)."""
    n_users = len(offsets) - 1
    counts = np.diff(offsets)
    mat = np.zeros((n_users, max_len), dtype=dtype)
    if len(flat):
        rows = np.repeat(np.arange(n_users), counts)
        cols = np.arange(len(flat)) - np.repeat(offsets[:-1], counts)
        mat[rows, cols] = flat
    return mat
