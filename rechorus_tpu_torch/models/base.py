"""Model base hierarchy (port of rechorus_tpu/models/base.py:29-146).

A model is an `nn.Module` whose keyword arguments are hyperparameters,
filled from CLI args + corpus statistics by `from_args`. It declares
which reader / runner / batcher it needs as class attributes, implements
`forward(feed) -> out_dict` with out_dict["prediction"] of shape
[B, n_candidates], and `loss(out_dict, feed) -> scalar` on plain tensors,
which autograd differentiates.
"""
from __future__ import annotations

import inspect
from typing import Any, ClassVar, Dict, List

import torch
from torch import nn

from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import INIT_STD


class BaseModel(nn.Module):
    reader: ClassVar[str] = "BaseReader"
    runner: ClassVar[str] = "BaseRunner"
    batcher: ClassVar[str] = "general"
    extra_log_args: ClassVar[list] = []
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

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--model_path", type=str, default="", help="Model save path (default: model/<model>/<run>.bin under the working directory).")
        parser.add_argument("--buffer", type=int, default=1,
                            help="Kept for CLI parity; feeds are assembled on device, no host buffering.")
        return parser

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

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Redraw every parameter N(0, 0.01) from `gen` (reference
        BaseModel.init_weights), on the device the generator lives on."""
        for p in self.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * INIT_STD)

    def loss(self, out_dict: Dict[str, torch.Tensor], feed: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    # ---- hooks mirroring the reference lifecycle ----
    def actions_after_train(self):
        pass


def count_variables(params) -> int:
    return sum(p.numel() for p in params)


class GeneralModel(BaseModel):
    """Top-k model base: BPR multi-negative loss, sampled negatives.

    Parity: reference src/models/BaseModel.py:154-214.
    """

    # Self-supervised models (BUIR/DirectAU) train without negatives
    train_with_neg: ClassVar[bool] = True

    def __init__(self, *, user_num: int = 0, item_num: int = 0, num_neg: int = 1,
                 dropout: float = 0.0, test_all: int = 0):
        super().__init__()
        self.user_num = user_num
        self.item_num = item_num
        self.num_neg = num_neg
        self.dropout = dropout
        self.test_all = test_all

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--num_neg", type=int, default=1,
                            help="The number of negative items during training.")
        parser.add_argument("--dropout", type=float, default=0,
                            help="Dropout probability for each deep layer")
        parser.add_argument("--test_all", type=int, default=0,
                            help="Whether testing on all the items.")
        return BaseModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        return {"user_num": corpus.n_users, "item_num": corpus.n_items}

    def lazy_table_specs(self) -> dict:
        """Embedding tables eligible for `--lazy_emb_adam` (touched-rows
        optimizer updates): {state_dict key: feed keys whose ids touch it}.
        Keys missing from a subclass's parameters are ignored (see
        ops/lazy_adam.resolve_lazy_rows); subclasses with differently
        named tables can override.

        CONSTRAINT (packed lane, --packed_opt_rows, default ON): every
        read of a listed table MUST go through TableEmbed's gather (the
        sparse-lookup context). During the epoch the current values live
        in the packed [N, 3D] block and the module's own `weight` is
        stale -- any bypass read (raw `weight` access, a loss term over the
        whole table) silently sees the values of the epoch's start. Models
        that need whole-table reads must NOT list that table here. Run
        with --debug_nan_placeholder 1 to NaN-fill the stale table and
        surface violations (the NaN-loss abort fires)."""
        return {
            "u_embeddings.weight": ("user_id",),
            "i_embeddings.weight": ("item_id",),
        }

    def loss(self, out_dict, feed):
        return losses.bpr_multi_neg(out_dict["prediction"])
