"""SLRC+ -- Hawkes-process recommender with relational excitations (port
of rechorus_tpu/models/sequential/slrcplus.py).

Reference behavior: src/models/sequential/SLRCPlus.py (Wang et al.,
WWW'19): prediction = MF base intensity (+ user / item bias) + the sum
over relations of alpha_r * kernel_r(dt), kernel = pi * Exp(beta).pdf +
(1 - pi) * Normal(mu, sigma).pdf of the time since the most recent
relationally connected history interaction; relation 0 is repeat
consumption. The intervals come in the feed (`SLRCBatcher`,
`kg.relational_intervals`).
CMD example:
  python -m rechorus_tpu_torch.main --model_name SLRCPlus --emb_size 64 --lr 5e-4 --l2 1e-5 \
      --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import math
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import _zeros, embed
from rechorus_tpu_torch.registry import register_model


def exp_pdf(dt, beta):
    return beta * torch.exp(-beta * dt)


def normal_pdf(dt, mu, sigma):
    return torch.exp(-((dt - mu) ** 2) / (2.0 * sigma ** 2)) / (sigma * math.sqrt(2.0 * math.pi))


@register_model("SLRCPlus")
class SLRCPlus(SequentialModel):
    reader: ClassVar[str] = "KGReader"
    batcher: ClassVar[str] = "slrc"
    extra_log_args: ClassVar[list] = ["emb_size"]
    candidate_aligned_keys: ClassVar[tuple] = ("relational_interval",)
    PARAM_INITS = {"global_alpha": _zeros}

    def __init__(self, *, emb_size: int = 64, time_scalar: int = 60 * 60 * 24 * 100,
                 relation_num: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.time_scalar, self.relation_num = emb_size, time_scalar, relation_num
        R = relation_num
        self.global_alpha = nn.Parameter(torch.zeros(()))
        for name in ("alphas", "pis", "mus", "betas", "sigmas"):
            self.add_module(name, embed(self.item_num, R))
        self.u_embeddings = embed(self.user_num, emb_size)
        self.i_embeddings = embed(self.item_num, emb_size)
        self.user_bias = embed(self.user_num, 1)
        self.item_bias = embed(self.item_num, 1)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--time_scalar", type=int, default=60 * 60 * 24 * 100,
                            help="Time scalar for time intervals.")
        return SequentialModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["relation_num"] = len(corpus.item_relations) + 1
        return kw

    def lazy_table_specs(self) -> dict:
        # every [n_items, *] Hawkes table is gathered by the candidate ids,
        # the MF tables by user / item ids; global_alpha is a scalar and
        # stays dense
        specs = {name + ".weight": ("item_id",)
                 for name in ("i_embeddings", "item_bias", "alphas", "pis", "mus", "betas", "sigmas")}
        specs.update({"u_embeddings.weight": ("user_id",), "user_bias.weight": ("user_id",)})
        return specs

    def forward(self, feed, training: bool = False, gen=None):
        u_ids, i_ids = feed["user_id"], feed["item_id"]
        r_intervals = feed["relational_interval"]                          # [B, C, R]
        alphas = self.global_alpha + self.alphas(i_ids)
        pis = self.pis(i_ids) + 0.5
        mus = self.mus(i_ids) + 1.0
        betas = (self.betas(i_ids) + 1.0).clamp(1e-10, 10.0)
        sigmas = (self.sigmas(i_ids) + 1.0).clamp(1e-10, 10.0)
        mask = (r_intervals >= 0).float()
        delta_t = r_intervals * mask
        decay = pis * exp_pdf(delta_t, betas) + (1 - pis) * normal_pdf(delta_t, mus, sigmas)
        excitation = (alphas * decay * mask).sum(-1)                       # [B, C]
        u_vec = self.u_embeddings(u_ids)
        i_vec = self.i_embeddings(i_ids)
        base = (u_vec[:, None, :] * i_vec).sum(-1) + self.user_bias(u_ids) + self.item_bias(i_ids)[..., 0]
        return {"prediction": base + excitation}
