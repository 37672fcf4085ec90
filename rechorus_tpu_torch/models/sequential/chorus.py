"""Chorus -- knowledge- and time-aware item modeling, in two stages (port
of rechorus_tpu/models/sequential/chorus.py).

Reference behavior: src/models/sequential/Chorus.py (Wang et al.,
SIGIR'20). Stage 1 pretrains TransE KG embeddings over the reversed
relation triplets with a margin ranking loss (kg_forward 155-166, loss
168-177) and saves EVERY epoch to a well-known path; stage 2 loads them
and trains recommendation: per-relation temporal kernels (exponential /
complement = normal / substitute = -normal + normal; kernel_functions
100-120) weight relation-translated item embeddings (rec_forward
122-153), scored by BPR or GMF; the KG-pretrained tables train at
--lr_scale times the lr (customize_parameters 179-196).

Both stages hold every parameter, so stage 2 loads the stage-1 file as
a whole `state_dict` (the port's checkpoint format: both stages must run
in the port).
CMD example:
  python -m rechorus_tpu_torch.main --model_name Chorus --emb_size 64 --margin 1 --lr 5e-4 \
      --l2 1e-5 --epoch 50 --early_stop 0 --batch_size 512 --stage 1 \
      --dataset Grocery_and_Gourmet_Food
  python -m rechorus_tpu_torch.main --model_name Chorus --emb_size 64 --margin 1 --lr_scale 0.1 \
      --lr 1e-3 --l2 0 --base_method BPR --stage 2 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import logging
import math
import os
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel, stage_path
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.parallel.mesh import take_rows
from rechorus_tpu_torch.registry import register_model
from rechorus_tpu_torch.weights import read_checkpoint


@register_model("Chorus")
class Chorus(SequentialModel):
    reader: ClassVar[str] = "KGReader"
    batcher: ClassVar[str] = "chorus"
    extra_log_args: ClassVar[list] = ["margin", "lr_scale", "stage"]
    candidate_aligned_keys: ClassVar[tuple] = ("relational_interval", "category_id")

    def __init__(self, *, emb_size: int = 64, stage: int = 2, base_method: str = "BPR",
                 time_scalar: int = 60 * 60 * 24 * 100, category_col="i_category",
                 lr_scale: float = 0.1, margin: float = 1.0, relation_num: int = 1,
                 relations: tuple = (), category_num: int = 1, pretrain_path: str = "", **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.stage, self.base_method = emb_size, stage, base_method
        self.time_scalar, self.category_col, self.lr_scale = time_scalar, category_col, lr_scale
        self.margin, self.relation_num, self.relations = margin, relation_num, tuple(relations)
        self.category_num, self.pretrain_path = category_num, pretrain_path
        R, d = relation_num, emb_size
        # raw parameters, as in the JAX model (flax `self.param`), all of
        # them in both stages
        self.u_embeddings = nn.Parameter(torch.empty(self.user_num, d))
        self.i_embeddings = nn.Parameter(torch.empty(self.item_num, d))
        self.r_embeddings = nn.Parameter(torch.empty(R, d))
        self.betas = nn.Parameter(torch.empty(category_num, R))
        self.mus = nn.Parameter(torch.empty(category_num, R))
        self.sigmas = nn.Parameter(torch.empty(category_num, R))
        self.prediction_w = nn.Parameter(torch.empty(d, 1))
        self.user_bias = nn.Parameter(torch.empty(self.user_num, 1))
        self.item_bias = nn.Parameter(torch.empty(self.item_num, 1))

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--stage", type=int, default=2,
                            help="Stage of training: 1-KG_pretrain, 2-recommendation.")
        parser.add_argument("--base_method", type=str, default="BPR",
                            help="Basic method to generate recommendations: BPR, GMF")
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--time_scalar", type=int, default=60 * 60 * 24 * 100,
                            help="Time scalar for time intervals.")
        parser.add_argument("--category_col", type=str, default="i_category",
                            help="The name of category column in item_meta.csv.")
        parser.add_argument("--lr_scale", type=float, default=0.1,
                            help="Scale the lr for parameters in pre-trained KG model.")
        parser.add_argument("--margin", type=float, default=1,
                            help="Margin in hinge loss.")
        return SequentialModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["relation_num"] = len(corpus.item_relations) + 1
        kw["relations"] = tuple(corpus.item_relations)
        if args.category_col in corpus.item_meta_df.columns:
            kw["category_col"] = args.category_col
            kw["category_num"] = int(corpus.item_meta_df[args.category_col].max()) + 1
        else:
            kw["category_col"] = None
            kw["category_num"] = 1  # a virtual global category
        # stage 1 saves to a well-known path that stage 2 loads
        kw["pretrain_path"] = stage_path(args, "../model/Chorus", "KG__{}__emb_size={}__margin={}.bin"
                                         .format(args.dataset, args.emb_size, args.margin))
        if args.stage == 1:
            args.model_path = kw["pretrain_path"]
        return kw

    def forward(self, feed, training: bool = False, gen=None):
        if "head_id" in feed:  # a stage-1 KG batch
            head = take_rows(self.i_embeddings, feed["head_id"])
            tail = take_rows(self.i_embeddings, feed["tail_id"])
            relation = self.r_embeddings[feed["relation_id"]]
            return {"prediction": -((head + relation - tail) ** 2).sum(-1)}
        u_ids, i_ids, c_ids = feed["user_id"], feed["item_id"], feed["category_id"]
        r_interval = feed["relational_interval"]                           # [B, C, R]
        u_vectors = take_rows(self.u_embeddings, u_ids)
        i_vectors = take_rows(self.i_embeddings, i_ids)
        b = (self.betas[c_ids] + 1.0).clamp(1e-10, 10.0)
        s = (self.sigmas[c_ids] + 1.0).clamp(1e-10, 10.0)
        m = self.mus[c_ids] + 1.0
        mask = (r_interval >= 0).float()
        decay = self._kernel_functions(r_interval * mask, b, s, m) * mask
        ri_vectors = i_vectors[:, :, None, :] + self.r_embeddings[None, None, :, :]
        chorus_vectors = i_vectors + (decay[:, :, :, None] * ri_vectors).sum(2)
        if self.base_method.upper().strip() == "GMF":
            prediction = ((u_vectors[:, None, :] * chorus_vectors) @ self.prediction_w)[..., 0]
        else:
            prediction = (u_vectors[:, None, :] * chorus_vectors).sum(-1)
            prediction = prediction + self.user_bias[u_ids] + self.item_bias[i_ids][..., 0]
        return {"prediction": prediction}

    def _kernel_functions(self, r_interval, betas, sigmas, mus):
        """Per-relation decay kernels (reference Chorus.py:100-120), chosen
        by relation NAME; each clipped to [-1, 1]."""

        def norm_pdf(x, mu, sigma):
            return torch.exp(-((x - mu) ** 2) / (2.0 * sigma ** 2)) / (sigma * math.sqrt(2 * math.pi))

        decays = []
        for r in range(self.relation_num):
            dt = r_interval[:, :, r]
            beta, sigma, mu = betas[:, :, r], sigmas[:, :, r], mus[:, :, r]
            if r > 0 and "complement" in self.relations[r - 1]:
                decay = norm_pdf(dt, 0.0, beta)
            elif r > 0 and "substitute" in self.relations[r - 1]:
                decay = -norm_pdf(dt, 0.0, beta) + norm_pdf(dt, mu, sigma)
            else:  # exponential by default
                decay = beta * torch.exp(-beta * dt)
            decays.append(decay.clamp(-1.0, 1.0))
        return torch.stack(decays, dim=2)

    def loss(self, out_dict, feed):
        if self.stage == 1 and "head_id" in feed:
            pred = out_dict["prediction"]
            pos, neg = pred[:, :2].reshape(-1), pred[:, 2:].reshape(-1)
            return torch.clamp_min(self.margin - (pos - neg), 0.0).mean()
        return losses.bpr_multi_neg(out_dict["prediction"])

    def post_init_state(self):
        """Stage 2 starts from the stage-1 file, the whole state_dict."""
        if self.stage != 2:
            return
        if not os.path.exists(self.pretrain_path):
            raise ValueError('Pre-trained KG model does not exist, please run with "--stage 1"')
        self.load_state_dict(read_checkpoint(self.pretrain_path, self, self.i_embeddings.device))
        logging.info("Load KG model from " + self.pretrain_path)

    def lr_scales(self):
        """Stage 2 trains the KG-pretrained tables at lr_scale times the lr
        (reference customize_parameters, Chorus.py:179-196); None in
        stage 1."""
        if self.stage != 2:
            return None
        return {k: (self.lr_scale if k in ("i_embeddings", "r_embeddings") else 1.0)
                for k, _ in self.named_parameters()}
