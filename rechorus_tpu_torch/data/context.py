"""Context-feature schema: canonical ordering + fused vocab layout (own
copy of rechorus_tpu/data/context.py, numpy only).

The reference keeps one nn.Embedding per feature in a ModuleDict
(src/models/context/FM.py:34-42). Here every categorical feature is fused
into ONE embedding table with per-feature vocab offsets: one gather instead
of F small ones.

Canonical feature order (parity with reference ContextModel.__init__,
src/models/BaseContextModel.py:43-44):
    user_features + item_features + situation_features + [user_id, item_id]
Kinds: 'cat' for *_c / *_id (embedding), 'float' for every other name
(Dense(1->d)): the suffix decides, so a column without one (Grocery's
`i_category`) is a float feature.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ContextSchema:
    names: Tuple[str, ...]
    kinds: Tuple[str, ...]  # 'cat' | 'float'
    offsets: Tuple[int, ...]  # vocab offset per cat feature (0 for floats)
    total_vocab: int
    user_names: Tuple[str, ...]
    item_names: Tuple[str, ...]
    situ_names: Tuple[str, ...]

    @property
    def n_features(self) -> int:
        return len(self.names)

    @property
    def cat_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.kinds) if k == "cat")

    @property
    def float_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.kinds) if k == "float")


def is_categorical(name: str) -> bool:
    return name.endswith("_c") or name.endswith("_id")


def build_schema(corpus) -> ContextSchema:
    names = tuple(
        list(corpus.user_feature_names)
        + list(corpus.item_feature_names)
        + list(corpus.situation_feature_names)
        + ["user_id", "item_id"]
    )
    kinds = tuple("cat" if is_categorical(n) else "float" for n in names)
    offsets = []
    acc = 0
    for n, k in zip(names, kinds):
        if k == "cat":
            offsets.append(acc)
            acc += int(corpus.feature_max[n])
        else:
            offsets.append(0)
    return ContextSchema(
        names=names,
        kinds=kinds,
        offsets=tuple(offsets),
        total_vocab=acc,
        user_names=tuple(corpus.user_feature_names),
        item_names=tuple(corpus.item_feature_names),
        situ_names=tuple(corpus.situation_feature_names),
    )


def _lookup_matrix(frame, names, n_rows: int) -> np.ndarray:
    """[n_rows, len(names)] float64: row id = the frame's index value, the
    ids outside [0, n_rows) dropped, rows without a frame row zero."""
    mat = np.zeros((n_rows, len(names)), dtype=np.float64)
    ids = frame.index.to_numpy().astype(np.int64)
    keep = (ids >= 0) & (ids < n_rows)
    mat[ids[keep]] = frame[list(names)].to_numpy(dtype=np.float64)[keep]
    return mat


def feature_matrices(corpus) -> Dict[str, np.ndarray]:
    """Dense lookup matrices for user/item features: item rows indexed by
    item id (row 0 and ids without metadata stay zero), the same for users.
    One vectorised assignment from the reader's id-indexed feature frames
    where the JAX package loops over a per-id dict; the arrays are equal."""
    out = {}
    if corpus.item_feature_names:
        out["item"] = _lookup_matrix(corpus.item_feature_df, corpus.item_feature_names,
                                     corpus.n_items)
    if corpus.user_feature_names:
        out["user"] = _lookup_matrix(corpus.user_feature_df, corpus.user_feature_names,
                                     corpus.n_users)
    return out
