"""Model base hierarchy, forward side (port of rechorus_tpu/models/base.py:
29-146).

A model is an `nn.Module` whose keyword arguments are hyperparameters,
filled from CLI args + corpus statistics by `from_args`, and implements
`forward(feed) -> out_dict` with out_dict["prediction"] of shape
[B, n_candidates].
"""
from __future__ import annotations

import inspect
from typing import Any, ClassVar, Dict, List

from torch import nn


class BaseModel(nn.Module):
    # Catalog-scoring protocol (full-catalog eval/serving): models that
    # factor as score(u, i) = u_v . table[i] (+ bias[i]) set this True and
    # accept forward(feed, catalog=True) returning {"u_v": [B, d]}. The
    # catalog is then scored as one [B, d] x [d, N] product against the
    # table at `catalog_table` (a submodule path whose `.weight` is the
    # table). `catalog_raw_table` is True when that table IS the raw
    # parameter (so serving can pre-build its grouped rescore copy once);
    # models with a transformed table (LightGCN's propagated embeddings)
    # set it False.
    supports_catalog: ClassVar[bool] = False
    catalog_table: ClassVar[tuple] = ("i_embeddings",)
    catalog_raw_table: ClassVar[bool] = True

    @classmethod
    def hyperparameters(cls) -> List[str]:
        """Keyword arguments of every `__init__` along the model's MRO."""
        names: List[str] = []
        for klass in cls.__mro__:
            if not (isinstance(klass, type) and issubclass(klass, BaseModel)):
                continue
            for p in inspect.signature(klass.__init__).parameters.values():
                if p.name != "self" and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY) \
                        and p.name not in names:
                    names.append(p.name)
        return names

    @classmethod
    def from_args(cls, args, corpus):
        """Build the module from parsed args + corpus statistics."""
        kwargs = {n: getattr(args, n) for n in cls.hyperparameters() if hasattr(args, n)}
        kwargs.update(cls.corpus_kwargs(args, corpus))
        return cls(**kwargs)

    @classmethod
    def corpus_kwargs(cls, args, corpus) -> Dict[str, Any]:
        return {}


class GeneralModel(BaseModel):
    """Top-k model base (reference src/models/BaseModel.py:154-214),
    forward side: the corpus sizes."""

    def __init__(self, *, user_num: int = 0, item_num: int = 0):
        super().__init__()
        self.user_num = user_num
        self.item_num = item_num

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        return {"user_num": corpus.n_users, "item_num": corpus.n_items}
