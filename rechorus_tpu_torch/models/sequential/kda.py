"""KDA and ContraKDA -- Knowledge-aware Dynamic Attention (port of
rechorus_tpu/models/sequential/kda.py).

Reference behavior: src/models/sequential/KDA.py (Wang et al., TOIS'21):
1) Relational dynamic history aggregation: per relation r, attention of
   relation-translated candidate embeddings over the history, modulated by
   a learnable inverse-DFT temporal decay that starts from the corpus's
   relational interval-distribution DFT (KDA.py:266-303; init 69-73).
2) Multi-layer self-attention over the relation axis + FFN (110-135).
3) Pooling (average/max/attention) -> his_vector; prediction =
   (u + his_vector) . candidate entity emb + item bias (137-160).
4) Joint loss = rec BPR + gamma * DistMult KG BPR (162-191).
CMD examples (bench.py's kda lane; ContraKDA's Grocery command):
  python -m rechorus_tpu_torch.main --model_name KDA --emb_size 64 --include_attr 1 \
      --freq_rand 0 --lr 1e-3 --l2 1e-6 --num_heads 4 --history_max 20 \
      --dataset Grocery_and_Gourmet_Food
  python -m rechorus_tpu_torch.main --model_name ContraKDA --emb_size 64 --include_attr 1 \
      --freq_rand 0 --lr 1e-3 --l2 1e-6 --num_heads 4 --history_max 20 --contra_gamma 0.3 \
      --ccc_temp 1.0 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import math
from typing import ClassVar

import numpy as np
import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel, target_col
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import Dense, LayerNorm, MultiHeadAttention, dropout, embed
from rechorus_tpu_torch.registry import register_model


@register_model("KDA")
class KDA(SequentialModel):
    reader: ClassVar[str] = "KDAReader"
    batcher: ClassVar[str] = "kda"
    extra_log_args: ClassVar[list] = ["num_layers", "num_heads", "gamma", "freq_rand", "include_val"]
    candidate_aligned_keys: ClassVar[tuple] = ("item_val",)

    def __init__(self, *, emb_size: int = 64, neg_head_p: float = 0.5, num_layers: int = 1,
                 num_heads: int = 1, gamma: float = -1.0, attention_size: int = 10,
                 pooling: str = "average", include_val: int = 1, t_scalar: int = 60,
                 freq_rand: int = 0, freq_dim: int = 33, relation_num: int = 1,
                 entity_num: int = 0, freq_x=None, **kwargs):
        """`freq_x` is the corpus's complex [relation_num, freq_dim] DFT;
        the frequency parameters start from its real and imaginary parts
        unless it is None (--freq_rand 1), when they start N(0, 0.01)."""
        super().__init__(**kwargs)
        self.emb_size, self.neg_head_p = emb_size, neg_head_p
        self.num_layers, self.num_heads, self.gamma = num_layers, num_heads, gamma
        self.attention_size, self.pooling, self.include_val = attention_size, pooling, include_val
        self.t_scalar, self.freq_rand, self.freq_dim = t_scalar, freq_rand, freq_dim
        self.relation_num, self.entity_num = relation_num, entity_num
        R, d = relation_num, emb_size
        self.user_embeddings = embed(self.user_num, d)
        self.entity_embeddings = embed(entity_num, d)
        self.relation_embeddings = nn.Parameter(torch.empty(R, d))
        self.freq_real = nn.Parameter(torch.empty(R, freq_dim))
        self.freq_imag = nn.Parameter(torch.empty(R, freq_dim))
        self.item_bias = embed(self.item_num, 1)
        if freq_x is not None:
            real = torch.from_numpy(np.real(freq_x).astype(np.float32))
            imag = torch.from_numpy(np.imag(freq_x).astype(np.float32))
            self.PARAM_INITS = {"freq_real": lambda shape, gen: real.to(gen.device),
                                "freq_imag": lambda shape, gen: imag.to(gen.device)}
        for k in range(num_layers):
            self.add_module(f"attn_{k}", MultiHeadAttention(d, num_heads, use_bias=False))
            self.add_module(f"w1_{k}", Dense(d, d))
            self.add_module(f"w2_{k}", Dense(d, d))
            self.add_module(f"ln_{k}", LayerNorm(d))
        if pooling == "attention":
            self.A = Dense(d, attention_size)
            self.A_out = Dense(attention_size, 1, use_bias=False)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--neg_head_p", type=float, default=0.5,
                            help="The probability of sampling negative head entity.")
        parser.add_argument("--num_layers", type=int, default=1, help="Number of self-attention layers.")
        parser.add_argument("--num_heads", type=int, default=1, help="Number of attention heads.")
        parser.add_argument("--gamma", type=float, default=-1,
                            help="Coefficient of KG loss (-1 for auto-determine).")
        parser.add_argument("--attention_size", type=int, default=10,
                            help="Size of attention hidden space.")
        parser.add_argument("--pooling", type=str, default="average",
                            help="Method of pooling relational history embeddings: average, max, attention")
        parser.add_argument("--include_val", type=int, default=1,
                            help="Whether include relation value in the relation representation")
        return SequentialModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["relation_num"] = corpus.n_relations
        kw["entity_num"] = corpus.n_entities
        kw["t_scalar"] = corpus.t_scalar
        kw["freq_dim"] = corpus.n_dft // 2 + 1
        kw["freq_rand"] = corpus.freq_rand
        if args.gamma < 0:
            kw["gamma"] = len(corpus.relation_df) / len(corpus.all_df)
        if not corpus.freq_rand:
            kw["freq_x"] = corpus.freq_x
        return kw

    def lazy_table_specs(self) -> dict:
        # the entity table is gathered by candidates, history, the KG
        # triple batch and item values (the last two keys are ContraKDA's
        # views); the relation and frequency tables are [R, *] and stay
        # dense
        return {
            "user_embeddings.weight": ("user_id",),
            "item_bias.weight": ("item_id",),
            "entity_embeddings.weight": (
                "item_id", "history_items", "item_val",
                "head_id", "tail_id", "value_id",
                "history_items_a", "history_items_b",
            ),
        }

    def _idft_decay(self, delta_t: torch.Tensor) -> torch.Tensor:
        """Learnable temporal decay per relation by inverse DFT with
        conjugate symmetry (reference RelationalDynamicAggregation.
        idft_decay, KDA.py:276-286), as the JAX package computes it: the
        mean over one half of the symmetric spectrum, two [B*H, F] x [F, R]
        products. delta_t [B, H] -> [B, H, R]."""
        F = self.freq_dim
        freq = torch.linspace(0.0, 1.0, F, device=delta_t.device) / 2.0
        w = 2.0 * math.pi * freq * delta_t[..., None]  # [B, H, F]
        real = torch.cos(w) @ self.freq_real.T
        imag = torch.sin(w) @ self.freq_imag.T
        return (real - imag) / (2.0 * F)

    def encode(self, i_vec, v_vec, hist, delta_t, u_vectors, training: bool = False, gen=None):
        """Relational dynamic aggregation + relation self-attention +
        pooling -> per-candidate history vector [B, C, d] (KDA.py:288-303).
        i_vec [B, C, d], v_vec [B, C, R, d], hist / delta_t [B, H]. Shared
        by every encoding of a forward (ContraKDA encodes two more views)."""
        rel = self.relation_embeddings
        his_vecs = self.entity_embeddings(hist)  # [B, H, d]
        if self.include_val:
            ri_vectors = (rel[None, None, :, :] + v_vec) * i_vec[:, :, None, :]  # [B, C, R, d]
        else:
            ri_vectors = rel[None, None, :, :] * i_vec[:, :, None, :]
        attention = torch.einsum("bhd,bcrd->bchr", his_vecs, ri_vectors)
        valid = (hist > 0)[:, None, :, None]  # [B, 1, H, 1]
        attention = losses.masked_softmax(attention, valid.expand(attention.shape), dim=2)
        decay = self._idft_decay(delta_t).clamp(0.0, 1.0)
        decay = torch.where(valid[:, 0], decay, 0.0)[:, None, :, :]  # [B, 1, H, R]
        attention = attention * decay
        context = torch.einsum("bhd,bchr->bcrd", his_vecs, attention)  # [B, C, R, d]

        for k in range(self.num_layers):
            residual = context
            context = getattr(self, f"attn_{k}")(context, context, context)
            context = getattr(self, f"w1_{k}")(context)
            context = getattr(self, f"w2_{k}")(torch.relu(context))
            context = dropout(context, self.dropout, training, gen)
            context = getattr(self, f"ln_{k}")(residual + context)

        if self.pooling == "attention":
            query = context * u_vectors[:, None, None, :]
            att = self.A_out(torch.tanh(self.A(query)))[..., 0]
            # one max over the whole tensor, as the JAX model takes it
            att = torch.softmax(att - att.max().detach(), dim=-1)
            return (context * att[:, :, :, None]).sum(-2)
        if self.pooling == "max":
            return context.amax(dim=-2)
        return context.mean(dim=-2)  # [B, C, d]

    def forward(self, feed, training: bool = False, gen=None):
        u_ids, i_ids = feed["user_id"], feed["item_id"]
        u_vectors = self.user_embeddings(u_ids)  # [B, d]
        i_vectors = self.entity_embeddings(i_ids)  # [B, C, d]
        v_vectors = self.entity_embeddings(feed["item_val"])  # [B, C, R, d]
        his_vector = self.encode(i_vectors, v_vectors, feed["history_items"],
                                 feed["history_delta_t"], u_vectors, training, gen)
        i_bias = self.item_bias(i_ids)[..., 0]
        out = {"prediction": ((u_vectors[:, None, :] + his_vector) * i_vectors).sum(-1) + i_bias}
        if training and "history_items_a" in feed:
            # ContraKDA: the two augmented histories, each encoded by the
            # same relational encoder conditioned on the true target
            B, _, d = i_vectors.shape
            tcol = target_col(feed)
            tgt_i = i_vectors.gather(1, tcol[:, None, None].expand(B, 1, d))          # [B, 1, d]
            tgt_v = v_vectors.gather(1, tcol[:, None, None, None].expand(B, 1, *v_vectors.shape[2:]))
            views = [self.encode(tgt_i, tgt_v, feed[k], feed["history_delta_t"], u_vectors,
                                 training, gen)[:, 0] for k in ("history_items_a", "history_items_b")]
            out["features"] = losses.l2_normalize(torch.stack(views, dim=1))           # [B, 2, d]
            out["labels"] = i_ids.gather(1, tcol[:, None])[:, 0]
        if "head_id" in feed:  # the joint KG batch (train)
            head_v = self.entity_embeddings(feed["head_id"])  # [B, 1 + N, d]
            tail_v = self.entity_embeddings(feed["tail_id"])
            relation_v = self.relation_embeddings[feed["relation_id"]]  # [B, d]
            if self.include_val:
                relation_v = relation_v + self.entity_embeddings(feed["value_id"])
            out["kg_prediction"] = (head_v * relation_v[:, None, :] * tail_v).sum(-1)
        return out

    def loss(self, out_dict, feed):
        rec_loss = losses.bpr_multi_neg(out_dict["prediction"])
        kg_loss = losses.bpr_multi_neg(out_dict["kg_prediction"])
        return rec_loss + self.gamma * kg_loss


@register_model("ContraKDA")
class ContraKDA(KDA):
    """KDA + ContraRec's context-context contrastive training (JAX
    rechorus_tpu/models/sequential/kda.py:237-281; the reference lists
    ContraKDA's result but ships no source, so the composition is the JAX
    package's own): KDA scores the candidates as usual (+ the joint KG
    BPR), and two augmented history views (Beta-ratio masking to pad id 0,
    `ContraKDABatcher`) are encoded by the same relational encoder,
    conditioned on the true target, and pulled together by `infonce`."""

    batcher: ClassVar[str] = "contra_kda"
    batch_coupled: ClassVar[bool] = True   # in-batch context-context contrast
    extra_log_args: ClassVar[list] = [
        "num_layers", "num_heads", "gamma", "contra_gamma", "ccc_temp", "freq_rand"]

    def __init__(self, *, contra_gamma: float = 0.3, ccc_temp: float = 1.0, beta_a: int = 3,
                 beta_b: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.contra_gamma, self.ccc_temp, self.beta_a, self.beta_b = contra_gamma, ccc_temp, beta_a, beta_b

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--contra_gamma", type=float, default=0.3,
                            help="Coefficient of the context-context contrastive loss.")
        parser.add_argument("--ccc_temp", type=float, default=1.0,
                            help="Temperature of the contrastive loss.")
        parser.add_argument("--beta_a", type=int, default=3,
                            help="Beta-distribution parameter for view masking.")
        parser.add_argument("--beta_b", type=int, default=3,
                            help="Beta-distribution parameter for view masking.")
        return KDA.parse_model_args(parser)

    def loss(self, out_dict, feed):
        loss = super().loss(out_dict, feed)
        if "features" in out_dict:
            labels = out_dict["labels"]
            loss = loss + self.contra_gamma * self.ccc_temp * losses.infonce(
                out_dict["features"], temperature=self.ccc_temp,
                same_target_mask=labels[:, None] == labels[None, :])
        return loss
