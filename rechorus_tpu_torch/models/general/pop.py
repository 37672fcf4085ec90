"""POP -- rank items by train-set popularity; run with --train 0 (port of
rechorus_tpu/models/general/pop.py).

Reference behavior: src/models/general/POP.py.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rechorus_tpu_torch.models.base import GeneralModel
from rechorus_tpu_torch.ops.layers import _zeros
from rechorus_tpu_torch.registry import register_model


@register_model("POP")
class POP(GeneralModel):
    # a dummy parameter, so that --train 0 still has an optimizer to build
    PARAM_INITS = {"_unused": _zeros}

    def __init__(self, *, popularity=(), **kwargs):
        super().__init__(**kwargs)
        # derived from the corpus, not trained: rebuilt with the model, so it
        # stays out of the state_dict
        self.register_buffer("popularity", torch.as_tensor(np.asarray(popularity, np.float32)),
                             persistent=False)
        self._unused = nn.Parameter(torch.zeros(1))

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["popularity"] = np.bincount(corpus.data_df["train"]["item_id"].to_numpy(),
                                       minlength=corpus.n_items)
        return kw

    def flax_constants(self) -> dict:
        """The JAX package's `constants` collection, for its checkpoint file."""
        return {"popularity": self.popularity.cpu().numpy()}

    def forward(self, feed, training: bool = False, gen=None):
        return {"prediction": self.popularity[feed["item_id"]]}
