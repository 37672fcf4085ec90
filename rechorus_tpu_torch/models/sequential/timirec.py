"""TiMiRec -- target-interest distillation for multi-interest
recommendation, in two stages (port of
rechorus_tpu/models/sequential/timirec.py).

Reference behavior: src/models/sequential/TiMiRec.py (Wang et al.,
CIKM'22). Stage 'pretrain' trains the K-head MultiInterestExtractor
(attention pooling + optional position embeddings + optional
transformer, 158-205), scoring with the interest closest to the target,
and saves it to a well-known extractor path. Stage 'finetune' loads the
parameters of that file whose names it shares (load_model 97-106), adds a
GRU InterestPredictor and a projection MLP, and distills: KL(log_softmax(
pred_intent / T) || softmax(target_intent / T)) * T^2 added to the BPR
loss (146-156). Without the file, finetune trains from scratch.
CMD example:
  python -m rechorus_tpu_torch.main --model_name TiMiRec --emb_size 64 --lr 1e-4 --l2 1e-6 \
      --history_max 20 --K 6 --add_pos 1 --add_trm 1 --stage pretrain \
      --dataset Grocery_and_Gourmet_Food
  python -m rechorus_tpu_torch.main --model_name TiMiRec --emb_size 64 --lr 1e-4 --l2 1e-6 \
      --history_max 20 --K 6 --add_pos 1 --add_trm 1 --stage finetune --temp 1 --n_layers 1 \
      --check_epoch 10 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import logging
import os
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel, stage_path
from rechorus_tpu_torch.models.sequential.comirec import closest_interest, target_vectors
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import Dense, MaskedGRU, TransformerLayer, dropout, embed
from rechorus_tpu_torch.registry import register_model
from rechorus_tpu_torch.weights import read_checkpoint


class MultiInterestExtractor(nn.Module):
    """K attention heads over the history (reference TiMiRec.py:158-205)."""

    def __init__(self, k: int, item_num: int, emb_size: int, attn_size: int, max_his: int,
                 add_pos: int, add_trm: int):
        super().__init__()
        self.add_pos, self.add_trm = add_pos, add_trm
        self.i_embeddings = embed(item_num, emb_size)
        if add_pos:
            self.p_embeddings = embed(max_his + 1, emb_size)
        self.W1 = Dense(emb_size, attn_size)
        self.W2 = Dense(attn_size, k)
        if add_trm:
            self.transformer = TransformerLayer(emb_size, emb_size, 1, kq_same=False)

    def forward(self, history, lengths, training: bool = False, gen=None):
        L = history.shape[1]
        valid = history > 0
        his = self.i_embeddings(history)
        if self.add_pos:
            position = (lengths[:, None] - torch.arange(L, device=history.device)[None, :]) * valid
            his = his + self.p_embeddings(position)
        if self.add_trm:
            his = self.transformer(his, mask=valid[:, None, None, :], training=training, gen=gen)
            his = his * valid[:, :, None]
        attn = self.W2(torch.tanh(self.W1(his))).transpose(-1, -2)          # [B, K, L]
        attn = losses.masked_softmax(attn, valid[:, None, :], dim=-1)
        return attn @ his                                                   # [B, K, d]


class InterestPredictor(nn.Module):
    """GRU over the history -> its final state (reference
    TiMiRec.py:208-222)."""

    def __init__(self, item_num: int, emb_size: int):
        super().__init__()
        self.i_embeddings = embed(item_num + 1, emb_size)
        self.rnn = MaskedGRU(emb_size, emb_size)

    def forward(self, history, lengths):
        return self.rnn(self.i_embeddings(history), lengths)[1]


@register_model("TiMiRec")
class TiMiRec(SequentialModel):
    extra_log_args: ClassVar[list] = ["emb_size", "attn_size", "K", "temp", "add_pos", "add_trm", "n_layers"]

    def __init__(self, *, emb_size: int = 64, attn_size: int = 8, K: int = 2, add_pos: int = 1,
                 add_trm: int = 1, temp: float = 1.0, n_layers: int = 1, stage: str = "finetune",
                 extractor_path: str = "", **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.attn_size, self.K = emb_size, attn_size, K
        self.add_pos, self.add_trm, self.temp, self.n_layers = add_pos, add_trm, temp, n_layers
        self.stage, self.extractor_path = stage, extractor_path
        self.interest_extractor = MultiInterestExtractor(K, self.item_num, emb_size, attn_size,
                                                         self.history_max, add_pos, add_trm)
        if stage == "finetune":
            self.interest_predictor = InterestPredictor(self.item_num, emb_size)
            for i in range(n_layers - 1):
                self.add_module(f"proj_{i}", Dense(emb_size, emb_size))
            self.proj_final = Dense(emb_size, K)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--attn_size", type=int, default=8, help="Size of attention vectors.")
        parser.add_argument("--K", type=int, default=2, help="Number of hidden interests.")
        parser.add_argument("--add_pos", type=int, default=1,
                            help="Whether add position embedding in extractor.")
        parser.add_argument("--add_trm", type=int, default=1,
                            help="Whether add the transformer layer in extractor.")
        parser.add_argument("--temp", type=float, default=1,
                            help="Temperature in knowledge distillation loss.")
        parser.add_argument("--n_layers", type=int, default=1, help="Number of the projection layer.")
        parser.add_argument("--stage", type=str, default="finetune",
                            help="Training stage: pretrain / finetune.")
        return SequentialModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        if args.stage not in ("pretrain", "finetune"):
            raise ValueError("Invalid stage: " + args.stage)
        kw["extractor_path"] = stage_path(
            args, "../model/TiMiRec", "Extractor__{}__{}__emb_size={}__K={}__add_pos={}__add_trm={}.bin"
            .format(args.dataset, args.random_seed, args.emb_size, args.K, args.add_pos, args.add_trm))
        if args.stage == "pretrain":
            args.model_path = kw["extractor_path"]
        return kw

    def lazy_table_specs(self) -> dict:
        # out of --lazy_emb_adam, as in the JAX package
        return {}

    def forward(self, feed, training: bool = False, gen=None):
        history, lengths = feed["history_items"], feed["lengths"]
        interests = self.interest_extractor(history, lengths, training=training, gen=gen)   # [B, K, d]
        i_vectors = self.interest_extractor.i_embeddings(feed["item_id"])                   # [B, C, d]
        out = {}
        if self.stage == "pretrain":
            if training:
                user_vector = closest_interest(interests, target_vectors(feed, i_vectors))
                prediction = (user_vector[:, None, :] * i_vectors).sum(-1)
            else:
                prediction = (interests[:, None, :, :] * i_vectors[:, :, None, :]).sum(-1).amax(-1)
        else:
            x = self.interest_predictor(history, lengths)
            for i in range(self.n_layers - 1):
                x = torch.relu(dropout(getattr(self, f"proj_{i}")(x), 0.5, training, gen))
            pred_intent = self.proj_final(x)                                # [B, K]
            if training:
                target = losses.l2_normalize(target_vectors(feed, i_vectors))
                out["pred_intent"] = pred_intent
                out["target_intent"] = (losses.l2_normalize(interests) * target[:, None, :]).sum(-1)
            user_vector = (interests * torch.softmax(pred_intent, -1)[:, :, None]).sum(-2)
            prediction = (user_vector[:, None, :] * i_vectors).sum(-1)
        out["prediction"] = prediction
        return out

    def loss(self, out_dict, feed):
        loss = losses.bpr_multi_neg(out_dict["prediction"])
        if self.stage == "finetune":
            pred = F.log_softmax(out_dict["pred_intent"] / self.temp, dim=1)
            target = torch.softmax(out_dict["target_intent"].detach() / self.temp, dim=1)
            # KLDivLoss(reduction='batchmean')(log_p, q): mean over rows of sum q (log q - log_p)
            kl = (target * (torch.log(target.clamp_min(1e-12)) - pred)).sum(1).mean()
            loss = loss + self.temp * self.temp * kl
        return loss

    def post_init_state(self):
        """Finetune starts from the pretrained extractor: every parameter of
        the file whose name this model has (the extractor's)."""
        if self.stage != "finetune":
            return
        if not os.path.exists(self.extractor_path):
            logging.info("Train from scratch!")
            return
        own = self.state_dict()
        saved = read_checkpoint(self.extractor_path, self, next(self.parameters()).device)
        self.load_state_dict({k: v for k, v in saved.items() if k in own}, strict=False)
        logging.info("Load extractor from " + self.extractor_path)
