"""ETA -- end-to-end target attention with SimHash long-history retrieval
(port of rechorus_tpu/models/context_seq/eta.py).

Reference behavior: src/models/context_seq/ETA.py (Chen et al., 2021;
FuxiCTR-derived): the history splits into a recent (short) and an older
(long) part; the long part is compressed to the retrieval_k items most
similar to the target under a SimHash (LSH) Hamming similarity; both
parts go through MultiHeadTargetAttention, then a DNN. As in the JAX
package, the short / long masks read recency on LEFT-aligned sequences
(the reference's reversed arange assumes right alignment, ETA.py:200-203),
and retrieval and attention run over the candidate axis.

The LSH rotations are fixed and seed-independent, as the JAX package's
`jax.random.key(42)` draws (its 'constants' collection): persistent
buffers drawn from a torch generator seeded 42, so they travel in the
`state_dict` and `--load` reproduces the metrics; `weights.
from_flax_params` carries the JAX package's values.
"""
from __future__ import annotations

import ast
import logging
from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import ContextSeqCTRModel, ContextSeqModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.layers import MLPBlock, MultiHeadTargetAttention
from rechorus_tpu_torch.registry import register_model

_RETRIEVAL_NOTICED = set()


def _notice_paper_retrieval(cls_name: str):
    """One notice a class: the default --ref_retrieval 0 is the paper's
    bit-level Hamming retrieval, which departs from the reference's
    bucket-id scoring (its ETA.py:259-261)."""
    if cls_name not in _RETRIEVAL_NOTICED:
        _RETRIEVAL_NOTICED.add(cls_name)
        logging.info(
            "%s: --ref_retrieval 0 (default) uses paper-correct bit-level "
            "Hamming retrieval; this diverges from the reference "
            "implementation's bucket-id scoring (its ETA.py:259-261 bug). "
            "Pin --ref_retrieval 1 for reference-faithful parity runs.",
            cls_name)


def parse_fields(s):
    """A field flag ('["item_id"]', '[("item_id","i_category_c")]') as a
    tuple of names and name tuples."""
    v = ast.literal_eval(s)
    if not isinstance(v, list):
        v = [v]
    return tuple(tuple(f) if isinstance(f, (list, tuple)) else f for f in v)


class ETABase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "add_historical_situations"]
    # the long part attends over the retrieved items (SDIM sums collisions)
    LONG_ATTENTION: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, dnn_hidden_units=(128, 64), dnn_activations: str = "ReLU",
                 net_dropout: float = 0.0, batch_norm: int = 0, attention_dim: int = 64, num_heads: int = 1,
                 use_scale: int = 1, attention_dropout: float = 0.0, use_qkvo: int = 1,
                 retrieval_k: int = 5, reuse_hash: int = 1, num_hashes: int = 1, hash_bits: int = 4,
                 short_target_field=("item_id",), short_sequence_field=("history_item_id",),
                 long_target_field=("item_id",), long_sequence_field=("history_item_id",),
                 recent_k: int = 5, ref_retrieval: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.dnn_hidden_units = emb_size, tuple(dnn_hidden_units)
        self.attention_dim, self.num_heads, self.use_scale = attention_dim, num_heads, use_scale
        self.attention_dropout, self.use_qkvo = attention_dropout, use_qkvo
        self.retrieval_k, self.reuse_hash = retrieval_k, reuse_hash
        self.num_hashes, self.hash_bits = num_hashes, hash_bits
        self.short_target_field, self.short_sequence_field = short_target_field, short_sequence_field
        self.long_target_field, self.long_sequence_field = long_target_field, long_sequence_field
        self.recent_k, self.ref_retrieval = recent_k, ref_retrieval
        self.init_group_embeddings(emb_size)
        width = 0
        for i, (tf, _) in enumerate(zip(*self.short_fields())):
            d = self.field_width(tf)
            self.add_module(f"short_attention_{i}", self.attention(d))
            width += d
        for i, (tf, _) in enumerate(zip(*self.long_fields())):
            d = self.field_width(tf)
            if self.LONG_ATTENTION:
                self.add_module(f"long_attention_{i}", self.attention(d))
            # fixed rotations: --reuse_hash 0 (the reference redraws them at
            # every forward, ETA.py:255-256) is taken as 1, as in the JAX package
            self.register_buffer(f"random_rotations_{i}", torch.randn(
                (d, num_hashes, hash_bits), generator=torch.Generator().manual_seed(42)))
            width += d
        self.dnn = MLPBlock(width, self.dnn_hidden_units, dnn_activations, output_dim=1,
                            dropout_rate=net_dropout, norm="batch_norm" if batch_norm else None)

    def short_fields(self):
        return (self.short_target_field, self.short_sequence_field) if self.has_short() else ((), ())

    def long_fields(self):
        return (self.long_target_field, self.long_sequence_field) \
            if self.history_max > self.recent_k else ((), ())

    def has_short(self) -> bool:
        return True

    def attention(self, d: int) -> MultiHeadTargetAttention:
        return MultiHeadTargetAttention(d, self.attention_dim, self.num_heads, self.attention_dropout,
                                        bool(self.use_scale), bool(self.use_qkvo))

    def field_width(self, field) -> int:
        return (len(field) if isinstance(field, tuple) else 1) * self.emb_size

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--dnn_hidden_units", type=str, default="[128,64]", help="Size of each hidden layer.")
        parser.add_argument("--dnn_activations", type=str, default="ReLU", help="DNN activation.")
        parser.add_argument("--net_dropout", type=float, default=0, help="Dropout rate for DNN.")
        parser.add_argument("--batch_norm", type=int, default=0, help="Whether to use batch_norm.")
        parser.add_argument("--attention_dim", type=int, default=64, help="Size of attention hidden space.")
        parser.add_argument("--num_heads", type=int, default=1, help="Number of attention heads.")
        parser.add_argument("--use_scale", type=int, default=1, help="Scale attention weights.")
        parser.add_argument("--attention_dropout", type=float, default=0, help="Dropout rate for attention.")
        parser.add_argument("--use_qkvo", type=int, default=1, help="Separate qkvo projections.")
        parser.add_argument("--retrieval_k", type=int, default=5, help="Top-k retrieved from long history.")
        parser.add_argument("--reuse_hash", type=int, default=1, help="Reuse fixed hash rotations.")
        parser.add_argument("--num_hashes", type=int, default=1, help="Number of separate hashes.")
        parser.add_argument("--hash_bits", type=int, default=4, help="Bits per hash.")
        parser.add_argument("--short_target_field", type=str, default='["item_id"]')
        parser.add_argument("--short_sequence_field", type=str, default='["history_item_id"]')
        parser.add_argument("--long_target_field", type=str, default='["item_id"]')
        parser.add_argument("--long_sequence_field", type=str, default='["history_item_id"]')
        parser.add_argument("--recent_k", type=int, default=5, help="Short/long history threshold.")
        parser.add_argument("--ref_retrieval", type=int, default=0,
                            help="1 = bug-faithful reference retrieval scoring "
                                 "(-|bucket_id diff| with FuxiCTR's -hash_bits masked "
                                 "fill, ETA.py:259-261): masked slots outrank real "
                                 "history for hash_bits >= 3, so retrieval degenerates. "
                                 "Parity-ablation only; 0 = paper-correct bit-level "
                                 "Hamming (see topk_retrieval).")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["dnn_hidden_units"] = tuple(ast.literal_eval(args.dnn_hidden_units))
        for f in ("short_target_field", "short_sequence_field", "long_target_field", "long_sequence_field"):
            kw[f] = parse_fields(getattr(args, f))
        return kw

    # ---- named fields over the grouped embeddings ----
    @staticmethod
    def _index(names, fname) -> int:
        """Position of `fname` among a group's features: categorical
        (sorted) first, then float (sorted)."""
        from rechorus_tpu_torch.data.context import is_categorical

        cats = [n for n in names if is_categorical(n)]
        flts = [n for n in names if not is_categorical(n)]
        return cats.index(fname) if fname in cats else len(cats) + flts.index(fname)

    def field_embedding(self, g, name):
        """A named field's embedding: candidate-aligned [B, C, d] or, for a
        `history_` name, history-aligned [B, H, d]."""
        user_names, item_names, situ_names = self.source_names
        B, C = g["item"].shape[:2]
        if name.startswith("history_"):
            base = name[len("history_"):]
            if base == "item_id":
                return g["history"][..., 0, :]
            if base in item_names:
                return g["history"][..., 1 + self._index(item_names, base), :]
            if base in situ_names and "history_situ" in g:
                return g["history_situ"][..., self._index(situ_names, base), :]
            raise ValueError(f"Unknown history field {name}")
        if name == "item_id":
            return g["item"][..., 0, :]
        if name in item_names:
            return g["item"][..., 1 + self._index(item_names, name), :]
        if name == "user_id":
            return g["user"][:, None, 0, :].expand(B, C, -1)
        if name in user_names:
            return g["user"][:, None, 1 + self._index(user_names, name), :].expand(B, C, -1)
        if name in situ_names:
            return g["situ"][:, None, self._index(situ_names, name), :].expand(B, C, -1)
        raise ValueError(f"Unknown field {name}")

    def concat_field(self, g, field):
        names = field if isinstance(field, tuple) else (field,)
        return torch.cat([self.field_embedding(g, n) for n in names], dim=-1)

    def history_masks(self, feed):
        """(short, long) [B, H] on left-aligned sequences: recency
        r = length - 1 - p; short r <= recent_k, long r > recent_k."""
        lengths = feed["lengths"]
        p = torch.arange(feed["history_items"].shape[1], device=lengths.device)[None, :]
        valid = p < lengths[:, None]
        recency = lengths[:, None] - 1 - p
        return valid & (recency <= self.recent_k), valid & (recency > self.recent_k)

    @staticmethod
    def lsh_code(vecs, rotations):
        """[.., L, d] -> [.., L, nh, bits] SimHash sign bits: relu(sign(.)),
        so a projection of exactly 0 gives bit 0."""
        return torch.relu(torch.sign(torch.einsum("...ld,dht->...lht", vecs, rotations)))

    def lsh_hash(self, vecs, rotations):
        """[.., L, d] -> [.., L, num_hashes] bucket ids (ETA.py:277-287)."""
        powers = 2.0 ** torch.arange(self.hash_bits, device=vecs.device, dtype=vecs.dtype)
        return (self.lsh_code(vecs, rotations) * powers).sum(-1)

    def topk_retrieval(self, rotations, target, sequence, mask):
        """SimHash Hamming top-k per candidate (ETA.py:254-270). target
        [B, C, D], sequence [B, H, D], mask [B, H] -> (retrieved [B, C, k, D],
        their mask [B, C, k]).

        --ref_retrieval 0 scores the paper's bit-level Hamming agreement
        and fills masked slots strictly below its minimum; 1 reproduces the
        reference's -|bucket id difference| with FuxiCTR's -hash_bits fill
        (ETA.py:259-261; see the JAX package's docstring). The scores are
        small integers, so ties at the k-th place are the rule: a stable
        descending sort keeps the lowest index among equals, as
        `jax.lax.top_k` does (`torch.topk` promises no tie order)."""
        if self.ref_retrieval:
            seq_hash = self.lsh_hash(sequence, rotations)                       # [B, H, nh]
            tgt_hash = self.lsh_hash(target, rotations)                         # [B, C, nh]
            sim = -(tgt_hash[:, :, None, :] - seq_hash[:, None, :, :]).abs().sum(-1)
            sim = torch.where(mask[:, None, :], sim, torch.full_like(sim, -float(self.hash_bits)))
        else:
            _notice_paper_retrieval(type(self).__name__)
            seq_code = self.lsh_code(sequence, rotations)                       # [B, H, nh, bits]
            tgt_code = self.lsh_code(target, rotations)                         # [B, C, nh, bits]
            sim = -(tgt_code[:, :, None] != seq_code[:, None]).sum((-1, -2)).float()
            fill = -float(self.num_hashes * self.hash_bits) - 1.0
            sim = torch.where(mask[:, None, :], sim, torch.full_like(sim, fill))
        k = min(self.retrieval_k, sim.shape[-1])
        idx = torch.sort(sim, dim=-1, descending=True, stable=True).indices[..., :k]   # [B, C, k]
        rows = torch.arange(sim.shape[0], device=sim.device)[:, None, None]
        return sequence[rows, idx], mask[rows, idx]

    def long_feature(self, i, rotations, t, s, mask_long, training, gen):
        """ETA's long part: attention within each candidate's retrieved list."""
        B, C, D = t.shape
        topk_emb, topk_mask = self.topk_retrieval(rotations, t, s, mask_long)
        K = topk_emb.shape[2]
        att = getattr(self, f"long_attention_{i}")
        return att(t.reshape(B * C, 1, D), topk_emb.reshape(B * C, K, D), topk_mask.reshape(B * C, 1, K),
                   training, gen).reshape(B, C, D)

    def prediction(self, feed, training, gen):
        g = self.group_embeddings(feed)
        mask_short, mask_long = self.history_masks(feed)
        B, C = g["item"].shape[:2]
        feats = []
        for i, (tf, sf) in enumerate(zip(*self.short_fields())):
            t, s = self.concat_field(g, tf), self.concat_field(g, sf)
            m = mask_short[:, None, :].expand(B, C, s.shape[1])
            feats.append(getattr(self, f"short_attention_{i}")(t, s, m, training, gen))
        for i, (tf, sf) in enumerate(zip(*self.long_fields())):
            t, s = self.concat_field(g, tf), self.concat_field(g, sf)
            feats.append(self.long_feature(i, getattr(self, f"random_rotations_{i}"), t, s, mask_long,
                                           training, gen))
        return self.dnn(torch.cat(feats, dim=-1), training, gen)[..., 0], None


@register_model("ETACTR")
class ETACTR(ETABase, ContextSeqCTRModel):
    pass


@register_model("ETATopK")
class ETATopK(ETABase, ContextSeqModel):
    pass
