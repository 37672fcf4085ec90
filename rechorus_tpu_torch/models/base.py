"""Model base hierarchy (port of rechorus_tpu/models/base.py:29-677: the
general, sequential and CTR bases, the context fields with their grouped
embeddings, the context and context-sequential bases, and the impression
and re-rank bases).

A model is an `nn.Module` whose keyword arguments are hyperparameters,
filled from CLI args + corpus statistics by `from_args`. It declares
which reader / runner / batcher it needs as class attributes, implements
`forward(feed, training=False, gen=None) -> out_dict` with
out_dict["prediction"] of shape [B, n_candidates], and
`loss(out_dict, feed) -> scalar` on plain tensors (CTR models: a [B]
prediction and the feed's labels), which autograd
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
from rechorus_tpu_torch.parallel.mesh import full_table, shard_of


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
    # override `catalog_item_table`. A multi-interest model (ComiRec) sets
    # `multi_interest`: its `u_v` is [B, K, d], and an item scores
    # max_k u_v[:, k] . table[i] (+ bias[i]) on every catalog route
    # (ops.topk, serve.dense_catalog_scores); ServeIndex and the sharded
    # routes refuse it.
    supports_catalog: ClassVar[bool] = False
    multi_interest: ClassVar[bool] = False
    catalog_table: ClassVar[tuple] = ("i_embeddings",)
    catalog_raw_table: ClassVar[bool] = True
    # A loss that couples the rows of a batch (in-batch negatives, batch
    # uniformity) is not the mean of per-row terms: on a mesh such a model
    # trains every data rank on the whole batch instead of its slice
    # (runners/base.py), as do models with BatchNorm (batch statistics).
    batch_coupled: ClassVar[bool] = False
    # How the training loss reduces the rows of a batch: "mean" or "sum" of
    # per-row terms. A data-parallel step averages or sums the data ranks'
    # gradients (and losses) by it.
    loss_reduction: ClassVar[str] = "mean"

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
            if klass in (object, nn.Module) or "__init__" not in vars(klass):
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

    def catalog_item_table(self, local: bool = False) -> torch.Tensor:
        """The [N, d] f32 table the catalog protocol scores `u_v` against
        (gathered over 'model' when row-sharded), or with `local` this
        rank's row block of it (the sharded catalog route). A bf16 table is
        cast here, once per call (bf16 -> f32 is exact): the rank and top-k
        kernels take f32 tables."""
        node = self
        for name in self.catalog_table:
            node = getattr(node, name)
        table = node.weight if local else full_table(node.weight)
        return table.detach().float().contiguous()

    def catalog_shard(self):
        """The ShardInfo of the catalog table's rows on this rank when it
        row-shards over 'model' (the sharded catalog route), else None."""
        node = self
        for name in self.catalog_table:
            node = getattr(node, name, None)
        return shard_of(getattr(node, "weight", None))

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


class CTRModel(BaseModel):
    """Pointwise CTR base: BCE/MSE on sigmoid outputs
    (reference BaseModel.py:247-288)."""

    reader: ClassVar[str] = "BaseReader"
    runner: ClassVar[str] = "CTRRunner"
    batcher: ClassVar[str] = "ctr"

    def __init__(self, *, user_num: int = 0, item_num: int = 0, dropout: float = 0.0,
                 loss_n: str = "BCE"):
        super().__init__()
        self.user_num, self.item_num = user_num, item_num
        self.dropout, self.loss_n = dropout, loss_n

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--dropout", type=float, default=0,
                            help="Dropout probability for each deep layer")
        parser.add_argument("--loss_n", type=str, default="BCE", help="Type of loss functions.")
        parser.add_argument("--num_neg", type=int, default=0,
                            help="CLI parity with the reference (its CTR scripts pass "
                                 "--num_neg 0); CTR training is pointwise, no sampling.")
        return BaseModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        return {"user_num": corpus.n_users, "item_num": corpus.n_items}

    def loss(self, out_dict, feed):
        if self.loss_n == "BCE":
            return losses.bce(out_dict["prediction"], feed["label"])
        elif self.loss_n == "MSE":
            return losses.mse(out_dict["prediction"], feed["label"])
        raise ValueError(f"Undefined loss function: {self.loss_n}")


# the schema keywords `_ContextFields.schema_kwargs` fills from the corpus
SCHEMA_KEYS = ("feature_names", "feature_kinds", "feature_offsets", "total_vocab",
               "n_situ_cat", "n_situ_float", "source_names", "feature_consts")


class _ContextFields:
    """Schema fields + feed assembly shared by the context families
    (filled by corpus_kwargs from data/context.build_schema).

    The user/item feature matrices are buffers on the model's device
    (`user_cat`, `user_float`, `item_cat`, `item_float`), derived from the
    corpus and kept out of the `state_dict`; the model gathers each
    candidate's features by id, so feeds stay small and the runner's
    anti-leak candidate permutation is safe (features follow item_id).
    """

    @classmethod
    def schema_kwargs(cls, corpus):
        from rechorus_tpu_torch.data.context import build_schema, feature_matrices, is_categorical

        schema = build_schema(corpus)
        mats = feature_matrices(corpus)
        consts = {}
        for side, names in (("user", schema.user_names), ("item", schema.item_names)):
            if side in mats:
                cat_cols = [i for i, n in enumerate(names) if is_categorical(n)]
                flt_cols = [i for i, n in enumerate(names) if not is_categorical(n)]
                consts[side + "_cat"] = mats[side][:, cat_cols].astype("int32")
                consts[side + "_float"] = mats[side][:, flt_cols].astype("float32")
        return {
            "feature_names": schema.names,
            "feature_kinds": schema.kinds,
            "feature_offsets": tuple(schema.offsets[i] for i in schema.cat_positions),
            "total_vocab": schema.total_vocab,
            "n_situ_cat": len([n for n in schema.situ_names if is_categorical(n)]),
            "n_situ_float": len([n for n in schema.situ_names if not is_categorical(n)]),
            "source_names": (schema.user_names, schema.item_names, schema.situ_names),
            "feature_consts": consts,
        }

    def init_context(self, feature_names=(), feature_kinds=(), feature_offsets=(), total_vocab=0,
                     n_situ_cat=0, n_situ_float=0, source_names=((), (), ()), feature_consts=None):
        self.feature_names, self.feature_kinds = tuple(feature_names), tuple(feature_kinds)
        self.feature_offsets, self.total_vocab = tuple(feature_offsets), total_vocab
        self.n_situ_cat, self.n_situ_float = n_situ_cat, n_situ_float
        self.source_names = tuple(tuple(n) for n in source_names)
        for k, v in (feature_consts or {}).items():
            t = torch.from_numpy(v)
            self.register_buffer(k, t.long() if not t.is_floating_point() else t, persistent=False)
        self.register_buffer("offsets_t", torch.tensor(self.feature_offsets, dtype=torch.long),
                             persistent=False)

    def _const(self, key):
        """The feature matrix buffer `key` (e.g. 'item_cat'), or None."""
        return getattr(self, key, None)

    def flax_constants(self) -> dict:
        """The corpus's feature matrices as the JAX package's `constants`
        collection holds them (int32 / float32), for its checkpoint file."""
        out = {}
        for key in ("user_cat", "user_float", "item_cat", "item_float"):
            m = self._const(key)
            if m is not None:
                out[key] = m.cpu().numpy().astype("int32" if key.endswith("_cat") else "float32")
        return out

    def init_group_embeddings(self, vec_size: int) -> None:
        """The modules of `group_embeddings`: one `fused_table` over every
        categorical vocabulary (ids included) and one bias-free Dense(1 ->
        vec_size) `float_<name>` per float feature, as the JAX package names
        them; and each group's categorical offsets as buffers."""
        from rechorus_tpu_torch.data.context import is_categorical
        from rechorus_tpu_torch.ops.layers import Dense, embed

        self.fused_table = embed(self.total_vocab, vec_size)
        for n in self.feature_names:
            if not is_categorical(n):
                self.add_module("float_" + n, Dense(1, vec_size, use_bias=False))
        cat_names = [n for n, k in zip(self.feature_names, self.feature_kinds) if k == "cat"]
        self.cat_offset = dict(zip(cat_names, self.feature_offsets))
        for group, names in zip(("user", "item", "situ"), self.source_names):
            offs = [self.cat_offset[n] for n in names if is_categorical(n)]
            self.register_buffer("offsets_" + group, torch.tensor(offs, dtype=torch.long), persistent=False)

    def _group(self, id_vals, id_key, side, names):
        """[..., F, d]: the fused-table rows of the ids (offset by
        `id_key`'s) and of the side's categorical features, then the float
        features' Dense rows (port of the JAX `group_embeddings.build`)."""
        from rechorus_tpu_torch.data.context import is_categorical

        cats = [id_vals[..., None] + self.cat_offset[id_key]]
        if any(is_categorical(n) for n in names):
            cats.append(self._const(side + "_cat")[id_vals] + getattr(self, "offsets_" + side))
        parts = [self.fused_table(torch.cat(cats, dim=-1))]
        flts = [n for n in names if not is_categorical(n)]
        if flts:
            src = self._const(side + "_float")[id_vals]
            parts += [getattr(self, "float_" + n)(src[..., j: j + 1])[..., None, :] for j, n in enumerate(flts)]
        return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]

    def _situ_group(self, cat_vals, float_vals):
        """[..., Fs, d] of situation values: categorical columns through the
        fused table, then the float ones through their Dense."""
        from rechorus_tpu_torch.data.context import is_categorical

        situ_names = self.source_names[2]
        parts = []
        if any(is_categorical(n) for n in situ_names):
            parts.append(self.fused_table(cat_vals.long() + self.offsets_situ))
        flts = [n for n in situ_names if not is_categorical(n)]
        parts += [getattr(self, "float_" + n)(float_vals[..., j: j + 1].float())[..., None, :]
                  for j, n in enumerate(flts)]
        return torch.cat(parts, dim=-2)

    def group_embeddings(self, feed, include_history: bool = True, extra_item_ids=None):
        """Per-group stacked embeddings from one fused table (port of
        rechorus_tpu/models/base.py:248-351; reference DIN.get_all_embedding,
        src/models/context_seq/DIN.py:97-137):
          'item'    [B, C, Fi, d]  item_id + i_* of each candidate
          'user'    [B, Fu, d]     user_id + u_*
          'situ'    [B, Fs, d]     c_* (when the corpus has them)
          'history' [B, H, Fi, d]  the history items and their i_*
          'history_situ' [B, H, Fs, d] when the feed carries it
        and one [..., Fi, d] entry per `extra_item_ids` key (DIEN's negative
        history). Within a group: id, categorical (sorted), float (sorted)."""
        user_names, item_names, situ_names = self.source_names
        out = {"item": self._group(self._items(feed), "item_id", "item", item_names),
               "user": self._group(feed["user_id"], "user_id", "user", user_names)}
        if situ_names:
            n_cat = self.n_situ_cat
            out["situ"] = self._situ_group(feed.get("situ_cat"), feed.get("situ_float"))
        history = include_history and "history_items" in feed
        if history:
            out["history"] = self._group(feed["history_items"], "item_id", "item", item_names)
        for key, ids in (extra_item_ids or {}).items():
            out[key] = self._group(ids, "item_id", "item", item_names)
        if history and "history_situ" in feed and situ_names:
            hs = feed["history_situ"]
            out["history_situ"] = self._situ_group(hs[..., :n_cat], hs[..., n_cat:])
        return out

    @staticmethod
    def _items(feed):
        items = feed["item_id"]
        return items[:, None] if items.dim() == 1 else items

    def feature_value(self, feed, name):
        """Raw value of a named context feature, shaped [B, C]. Used by
        models that condition on specific features (FinalMLP's feature
        selection)."""
        from rechorus_tpu_torch.data.context import is_categorical

        users, items = feed["user_id"], self._items(feed)
        B, C = items.shape
        if name == "user_id":
            return users[:, None].expand(B, C)
        if name == "item_id":
            return items
        user_names, item_names, situ_names = self.source_names
        cat = is_categorical(name)
        kind = "cat" if cat else "float"
        if name in user_names:
            col = [n for n in user_names if is_categorical(n) == cat].index(name)
            return self._const("user_" + kind)[users][:, None, col].expand(B, C)
        if name in item_names:
            col = [n for n in item_names if is_categorical(n) == cat].index(name)
            return self._const("item_" + kind)[items][..., col]
        if name in situ_names:
            col = [n for n in situ_names if is_categorical(n) == cat].index(name)
            return feed["situ_" + kind][:, None, col].expand(B, C)
        raise ValueError(f"Unknown context feature: {name}")

    def context_inputs(self, feed):
        """(cat_ids [B, C, F_cat] offset-applied, float_vals [B, C, F_float])
        in canonical order: user + item + situation + ids."""
        users, items = feed["user_id"], self._items(feed)
        B, C = items.shape
        cat_parts, float_parts = [], []
        for key, dest in (("user_cat", cat_parts), ("user_float", float_parts)):
            m = self._const(key)
            if m is not None and m.shape[1] > 0:
                dest.append(m[users][:, None, :].expand(B, C, m.shape[1]))
        for key, dest in (("item_cat", cat_parts), ("item_float", float_parts)):
            m = self._const(key)
            if m is not None and m.shape[1] > 0:
                dest.append(m[items])
        if self.n_situ_cat > 0:
            cat_parts.append(feed["situ_cat"].long()[:, None, :].expand(B, C, self.n_situ_cat))
        if self.n_situ_float > 0:
            float_parts.append(feed["situ_float"][:, None, :].expand(B, C, self.n_situ_float))
        cat_parts.append(users.long()[:, None, None].expand(B, C, 1))
        cat_parts.append(items.long()[:, :, None])
        cat_ids = torch.cat(cat_parts, dim=-1) + self.offsets_t
        if float_parts:
            float_vals = torch.cat(float_parts, dim=-1).float()
        else:
            float_vals = torch.zeros((B, C, 0), device=items.device)
        return cat_ids, float_vals


def _pop_schema(kwargs) -> dict:
    return {k: kwargs.pop(k) for k in SCHEMA_KEYS if k in kwargs}


class ContextModel(GeneralModel, _ContextFields):
    """Context-aware top-k model base (reference BaseContextModel.py:30-71):
    BPR loss (inherited) or multi-negative BCE. Its lazy tables are
    GeneralModel's, which its parameters lack: `--lazy_emb_adam 1` resolves
    no table and the first step raises, as in the JAX package."""

    reader: ClassVar[str] = "ContextReader"
    runner: ClassVar[str] = "BaseRunner"
    batcher: ClassVar[str] = "context"

    def __init__(self, *, loss_n: str = "BPR", **kwargs):
        schema = _pop_schema(kwargs)
        super().__init__(**kwargs)
        self.loss_n = loss_n
        self.init_context(**schema)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--loss_n", type=str, default="BPR", help="Type of loss functions.")
        return GeneralModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw.update(cls.schema_kwargs(corpus))
        return kw

    def loss(self, out_dict, feed):
        if self.loss_n == "BPR":
            return losses.bpr_multi_neg(out_dict["prediction"])
        elif self.loss_n == "BCE":
            # multi-negative BCE (reference BaseContextModel.py:52-56)
            predictions = torch.sigmoid(out_dict["prediction"])
            pos_pred, neg_pred = predictions[:, 0], predictions[:, 1:]
            return -(torch.log(pos_pred.clamp_min(1e-12))
                     + torch.log((1 - neg_pred).clamp_min(1e-12)).sum(dim=1)).mean()
        raise ValueError(f"Undefined loss function: {self.loss_n}")


class ContextCTRModel(CTRModel, _ContextFields):
    """Context-aware CTR base (reference BaseContextModel.py:74-87)."""

    reader: ClassVar[str] = "ContextReader"
    runner: ClassVar[str] = "CTRRunner"
    batcher: ClassVar[str] = "context_ctr"

    def __init__(self, **kwargs):
        schema = _pop_schema(kwargs)
        super().__init__(**kwargs)
        self.init_context(**schema)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw.update(cls.schema_kwargs(corpus))
        return kw


class ContextSeqModel(ContextModel):
    """Context + history, top-k (port of rechorus_tpu/models/base.py:
    495-509; reference BaseContextModel.py:89-124)."""

    reader: ClassVar[str] = "ContextSeqReader"
    batcher: ClassVar[str] = "context_seq"

    def __init__(self, *, history_max: int = 20, add_historical_situations: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.history_max, self.add_historical_situations = history_max, add_historical_situations

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--history_max", type=int, default=20, help="Maximum length of history.")
        parser.add_argument("--add_historical_situations", type=int, default=0,
                            help="Whether to add historical situation context as sequence.")
        return ContextModel.parse_model_args(parser)


class ContextSeqCTRModel(ContextCTRModel):
    """Context + history, CTR (port of rechorus_tpu/models/base.py:512-526;
    reference BaseContextModel.py:129-166)."""

    reader: ClassVar[str] = "ContextSeqReader"
    batcher: ClassVar[str] = "context_seq_ctr"

    def __init__(self, *, history_max: int = 20, add_historical_situations: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.history_max, self.add_historical_situations = history_max, add_historical_situations

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--history_max", type=int, default=20, help="Maximum length of history.")
        parser.add_argument("--add_historical_situations", type=int, default=0,
                            help="Whether to add historical situation context as sequence.")
        return ContextCTRModel.parse_model_args(parser)


class ImpressionModel(GeneralModel):
    """Listwise impression model base (port of rechorus_tpu/models/base.py:
    529-563; reference BaseImpressionModel.py:10-211): the logged pos/neg
    lists padded to fixed caps, the four listwise loss families, no
    train-time sampling and no anti-leak permutation (the pos | neg column
    layout is the structure the loss reads)."""

    reader: ClassVar[str] = "ImpressionReader"
    runner: ClassVar[str] = "ImpressionRunner"
    batcher: ClassVar[str] = "impression"
    permute_candidates: ClassVar[bool] = False

    def __init__(self, *, loss_n: str = "BPR", train_max_pos_item: int = 20,
                 train_max_neg_item: int = 20, test_max_pos_item: int = 20,
                 test_max_neg_item: int = 20, **kwargs):
        super().__init__(**kwargs)
        self.loss_n = loss_n
        self.train_max_pos_item, self.train_max_neg_item = train_max_pos_item, train_max_neg_item
        self.test_max_pos_item, self.test_max_neg_item = test_max_pos_item, test_max_neg_item

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--loss_n", type=str, default="BPR",
                            help="BPR(+after/before/simple/hard) | listnet | softmaxCE | attention_rank")
        parser.add_argument("--train_max_pos_item", type=int, default=20,
                            help="Max number of positive items per impression in training.")
        parser.add_argument("--train_max_neg_item", type=int, default=20,
                            help="Max number of negative items per impression in training.")
        parser.add_argument("--test_max_pos_item", type=int, default=20,
                            help="Max number of positive items per impression in testing.")
        parser.add_argument("--test_max_neg_item", type=int, default=20,
                            help="Max number of negative items per impression in testing.")
        return GeneralModel.parse_model_args(parser)

    def loss(self, out_dict, feed):
        return losses.impression_loss(out_dict["prediction"], feed["target"],
                                      self.train_max_pos_item, self.loss_n)


class ImpressionSeqModel(ImpressionModel):
    """+ the dual positive / negative history feeds (port of
    rechorus_tpu/models/base.py:566-578; reference BaseImpressionModel.py:
    213-277). Its lazy tables are ImpressionModel's: the history ids are
    not listed, so under --lazy_emb_adam their rows of the item table are
    read without gradient, as in the JAX package."""

    reader: ClassVar[str] = "ImpressionSeqReader"
    batcher: ClassVar[str] = "impression_seq"

    def __init__(self, *, history_max: int = 20, **kwargs):
        super().__init__(**kwargs)
        self.history_max = history_max

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--history_max", type=int, default=20, help="Maximum length of history.")
        return ImpressionModel.parse_model_args(parser)


class RerankModel(ImpressionModel):
    """Listwise re-ranker over a pre-trained base ranker (port of
    rechorus_tpu/models/base.py:581-662; reference BaseRerankerModel.py:
    15-84). The feeds gain the ranker's 'scores' (pads at -inf), 'position'
    (rank order of the scores), 'padding_mask', 'u_v' and 'i_v'.

    --tuneranker 0 (default): the ranker is frozen; the batcher runs it
    (data/batching._RerankFeeds), and it is not part of this module.
    --tuneranker 1: the ranker is a trainable submodule, `ranker_module`,
    whose parameters the batcher's `post_init_state` sets to the loaded
    checkpoint's; `rerank_feed` runs it inside the forward, so gradients
    reach it through scores / u_v / i_v (+ his_v); 'position' is an argsort
    rank, with no gradient, as in the reference."""

    reader: ClassVar[str] = "ImpressionReader"
    runner: ClassVar[str] = "ImpressionRunner"
    batcher: ClassVar[str] = "rerank"
    extra_log_args: ClassVar[list] = ["tuneranker"]
    needs_his_v: ClassVar[bool] = False

    def __init__(self, *, ranker_name: str = "BPRMF", ranker_config_file: str = "",
                 ranker_model_file: str = "", tuneranker: int = 0, ranker_emb_size: int = 64,
                 ranker_module=None, **kwargs):
        super().__init__(**kwargs)
        self.ranker_name, self.ranker_config_file = ranker_name, ranker_config_file
        self.ranker_model_file, self.tuneranker = ranker_model_file, tuneranker
        self.ranker_emb_size = ranker_emb_size
        if ranker_module is not None:
            self.ranker_module = ranker_module

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--ranker_name", type=str, default="BPRMF", help="Base ranker")
        parser.add_argument("--ranker_config_file", type=str, default="", help="Base ranker config file (yaml)")
        parser.add_argument("--ranker_model_file", type=str, default="", help="Base ranker model file")
        parser.add_argument("--tuneranker", type=int, default=0,
                            help="Fine-tune the loaded ranker jointly with the "
                                 "re-ranker (its params join the trainable set).")
        return ImpressionModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        from rechorus_tpu_torch import registry
        from rechorus_tpu_torch.models.reranker._loader import ranker_args

        kw = super().corpus_kwargs(args, corpus)
        r_args = ranker_args(args)
        kw["ranker_emb_size"] = int(getattr(r_args, "emb_size", 64))
        if getattr(args, "tuneranker", 0):
            kw["ranker_module"] = registry.get_model(args.ranker_name, "Impression").from_args(r_args, corpus)
        return kw

    def rerank_feed(self, feed):
        """The ranker-stage feed keys: already there in the frozen lane;
        computed by the trainable `ranker_module` in the tuned one."""
        if not self.tuneranker or "scores" in feed:
            return feed
        from rechorus_tpu_torch.data.batching import ranker_features

        return {**feed, **ranker_features(self.ranker_module, feed, self.needs_his_v)}


class RerankSeqModel(RerankModel):
    """+ the history feeds and 'his_v', the ranker's item vectors of the
    positive history (port of rechorus_tpu/models/base.py:663-677;
    reference BaseRerankerModel.py:86-133)."""

    reader: ClassVar[str] = "ImpressionSeqReader"
    batcher: ClassVar[str] = "rerank_seq"
    needs_his_v: ClassVar[bool] = True

    def __init__(self, *, history_max: int = 20, **kwargs):
        super().__init__(**kwargs)
        self.history_max = history_max

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--history_max", type=int, default=20, help="Maximum length of history.")
        return RerankModel.parse_model_args(parser)
