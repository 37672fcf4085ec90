"""Model base hierarchy (port of rechorus_tpu/models/base.py:29-168).

A model is an `nn.Module` whose keyword arguments are hyperparameters,
filled from CLI args + corpus statistics by `from_args`. It declares
which reader / runner / batcher it needs as class attributes, implements
`forward(feed, training=False, gen=None) -> out_dict` with
out_dict["prediction"] of shape [B, n_candidates], and
`loss(out_dict, feed) -> scalar` on plain tensors, which autograd
differentiates. `training` and the step's generator `gen` are what the
flax models get as `training` and the 'dropout' rng: the runner's train
step passes both, evaluation neither.
"""
from __future__ import annotations

import inspect
import os
from typing import Any, ClassVar, Dict, List

import torch
from torch import nn

from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import param_init


class BaseModel(nn.Module):
    reader: ClassVar[str] = "BaseReader"
    runner: ClassVar[str] = "BaseRunner"
    batcher: ClassVar[str] = "general"
    extra_log_args: ClassVar[list] = []
    # Catalog-scoring protocol (full-catalog eval/serving): models that
    # factor as score(u, i) = u_v . table[i] (+ bias[i]) set this True and
    # accept forward(feed, catalog=True) returning {"u_v": [B, d]}. The
    # catalog is then scored as one [B, d] x [d, N] product against
    # `catalog_item_table()`, which the runner builds once per evaluation
    # call: by default the table at `catalog_table` (a submodule path
    # whose `.weight` is the table). `catalog_raw_table` is True when that
    # table IS the raw parameter; models with a computed table (FPMC's
    # [iu | il], the JAX package's `i_table` output) set it False and
    # override `catalog_item_table`.
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
        """Redraw every parameter from `gen`, in `parameters()` order, on
        the device the generator lives on: N(0, 0.01) (reference
        BaseModel.init_weights) unless its module names another
        initialiser in `PARAM_INITS` (ops/layers.py)."""
        for mod in self.modules():
            for name, p in mod.named_parameters(recurse=False):
                p.copy_(param_init(mod, name)(p.shape, gen))

    def catalog_item_table(self) -> torch.Tensor:
        """The [N, d] f32 table the catalog protocol scores `u_v` against.
        A bf16 table is cast here, once per call (bf16 -> f32 is exact):
        the rank and top-k kernels take f32 tables."""
        node = self
        for name in self.catalog_table:
            node = getattr(node, name)
        return node.weight.detach().float().contiguous()

    def loss(self, out_dict: Dict[str, torch.Tensor], feed: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    # ---- hooks mirroring the reference lifecycle ----
    def actions_after_train(self):
        pass


def count_variables(params) -> int:
    return sum(p.numel() for p in params)


def target_col(feed) -> torch.Tensor:
    """[B] column of the true target among a train feed's candidates: the
    feed's `_target_col` (where the runner's anti-leak permutation put
    column 0), else 0."""
    tcol = feed.get("_target_col")
    if tcol is None:
        tcol = torch.zeros(feed["item_id"].shape[0], dtype=torch.long, device=feed["item_id"].device)
    return tcol


def stage_path(args, default_dir: str, name: str) -> str:
    """The file `name` of a two-stage model's first stage (Chorus's KG
    pretrain, TiMiRec's extractor): in the directory of --model_path, else
    in `default_dir` (reference Chorus.py:68-76, TiMiRec.py:76-84)."""
    base_dir = os.path.dirname(getattr(args, "model_path", "") or "") or default_dir
    return os.path.join(base_dir, name)


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


class SequentialModel(GeneralModel):
    """Adds truncated history feeds (reference BaseModel.py:216-245; JAX
    rechorus_tpu/models/base.py:149-168)."""

    reader: ClassVar[str] = "SeqReader"
    batcher: ClassVar[str] = "sequential"

    def __init__(self, *, history_max: int = 20, **kwargs):
        super().__init__(**kwargs)
        self.history_max = history_max

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--history_max", type=int, default=20,
                            help="Maximum length of history.")
        return GeneralModel.parse_model_args(parser)

    def lazy_table_specs(self) -> dict:
        specs = dict(super().lazy_table_specs())
        # history ids also gather from the item table (pad id 0 rides along:
        # its rows are masked out of every model's output, so its gradient
        # row is 0)
        specs["i_embeddings.weight"] = ("item_id", "history_items")
        return specs
