"""S3Rec -- self-supervised pretraining with MIP + SP objectives (port of
rechorus_tpu/models/developing/s3rec.py).

Reference behavior: src/models/developing/S3Rec.py: stage 1 pretrains a
BERT4Rec encoder over history_max-chunked user sequences with two
objectives: masked item prediction (random positions -> the mask token,
row item_num of the table; pos vs a sampled neg through `mip_norm`,
58-62) and segment prediction (a random contiguous segment masked out;
its encoding vs a random segment of the global stream through `sp_norm`,
64-66); loss = mip_weight * sum(BCE) + sp_weight * sum(BCE) (105-115),
each BCE clipped at 1e-7. Stage 2 starts from every parameter of the
stage-1 file whose name it shares and finetunes with BPR. The masking
and segment sampling run on the device in the 's3rec' batcher.

As in the JAX package, the MIP head scores each masked POSITION's encoder
output against its pos/neg item (the S3Rec paper's objective); the
reference broadcasts the sequence's final hidden state over all positions
(S3Rec.py:58-61). The inference branch is the same in both. The two
heads exist in stage 1 only (the JAX package creates them in its stage-1
branch). `lazy_table_specs` is empty: the mask-token rows are gathered
under no feed key, so `--lazy_emb_adam 1` trains dense, as in the JAX
package.
CMD example (stage 1 writes Pre__<dataset>.bin beside --model_path, stage 2
reads it):
  python -m rechorus_tpu_torch.main --model_name S3Rec --emb_size 64 --lr 1e-3 --l2 1e-6 \
      --history_max 20 --stage 1 --dataset Grocery_and_Gourmet_Food
  python -m rechorus_tpu_torch.main --model_name S3Rec --emb_size 64 --lr 1e-3 --l2 1e-6 \
      --history_max 20 --stage 2 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import logging
import os
from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import SequentialModel, stage_path
from rechorus_tpu_torch.models.sequential.contrarec import BERT4RecEncoder
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import Dense, embed
from rechorus_tpu_torch.registry import register_model
from rechorus_tpu_torch.weights import read_checkpoint


@register_model("S3Rec")
class S3Rec(SequentialModel):
    batcher: ClassVar[str] = "s3rec"
    extra_log_args: ClassVar[list] = ["emb_size", "mip_weight", "sp_weight", "mask_ratio", "stage"]

    def __init__(self, *, emb_size: int = 64, mip_weight: float = 0.2, sp_weight: float = 0.5,
                 mask_ratio: float = 0.2, stage: int = 1, pre_path: str = "", **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.mip_weight, self.sp_weight = emb_size, mip_weight, sp_weight
        self.mask_ratio, self.stage, self.pre_path = mask_ratio, stage, pre_path
        self.i_embeddings = embed(self.item_num + 1, emb_size)
        self.encoder = BERT4RecEncoder(emb_size, self.history_max, num_layers=2, num_heads=2,
                                       input_ln=True, dropout=0.2)
        if stage == 1:
            self.mip_norm = Dense(emb_size, emb_size)
            self.sp_norm = Dense(emb_size, emb_size)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--mip_weight", type=float, default=0.2, help="Coefficient of the MIP loss.")
        parser.add_argument("--sp_weight", type=float, default=0.5, help="Coefficient of the SP loss.")
        parser.add_argument("--mask_ratio", type=float, default=0.2,
                            help="Proportion of masked positions in the sequence.")
        parser.add_argument("--stage", type=int, default=1,
                            help="Stage of training: 1-pretrain, 2-finetune.")
        return SequentialModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["pre_path"] = stage_path(args, "../model/S3Rec", "Pre__{}.bin".format(args.dataset))
        if args.stage == 1:
            args.model_path = kw["pre_path"]
        return kw

    def lazy_table_specs(self) -> dict:
        return {}

    def forward(self, feed, training: bool = False, gen=None):
        enc = self.encoder
        if "mask_seq" in feed:  # a stage-1 pretrain batch
            mask_seq, seq_len = feed["mask_seq"], feed["seq_len"]
            # MIP: each position's encoder output against its pos / neg item
            seq_output = self.mip_norm(enc.encode_all(self.i_embeddings(mask_seq), seq_len, training, gen))
            pos_score = torch.sigmoid((seq_output * self.i_embeddings(feed["pos_item"])).sum(-1)).reshape(-1)
            neg_score = torch.sigmoid((seq_output * self.i_embeddings(feed["neg_item"])).sum(-1)).reshape(-1)
            L = mask_seq.shape[1]
            valid = torch.arange(L, device=mask_seq.device)[None, :] < seq_len[:, None]
            mip_mask = ((mask_seq == self.item_num) & valid).float()
            # SP: the segment-masked context against the pos / neg segments
            seg_ctx = enc(self.i_embeddings(feed["mask_seg_seq"]), seq_len, training, gen)
            pos_seg = enc(self.i_embeddings(feed["pos_seg"]), seq_len, training, gen)
            neg_seg = enc(self.i_embeddings(feed["neg_seg"]), seq_len, training, gen)
            ctx = self.sp_norm(seg_ctx)
            sp_pos = torch.sigmoid((ctx * pos_seg).sum(-1))
            sp_neg = torch.sigmoid((ctx * neg_seg).sum(-1))
            return {"mip_dis": torch.sigmoid(pos_score - neg_score), "mip_mask": mip_mask.reshape(-1),
                    "sp_dis": torch.sigmoid(sp_pos - sp_neg)}
        his_vector = enc(self.i_embeddings(feed["history_items"]), feed["lengths"], training, gen)
        i_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}

    @property
    def loss_reduction(self) -> str:
        # stage 1 sums its MIP and SP terms over the batch
        return "sum" if self.stage == 1 else "mean"

    def loss(self, out_dict, feed):
        if self.stage == 1:
            mip = -torch.log(out_dict["mip_dis"].clamp(1e-7, 1.0))
            sp = -torch.log(out_dict["sp_dis"].clamp(1e-7, 1.0))
            return self.mip_weight * (mip * out_dict["mip_mask"]).sum() + self.sp_weight * sp.sum()
        return losses.bpr_multi_neg(out_dict["prediction"])

    def post_init_state(self) -> None:
        """Stage 2 starts from every parameter of the stage-1 file whose
        name this model has (the JAX package merges the matching keys)."""
        if self.stage != 2:
            return
        if not os.path.exists(self.pre_path):
            logging.info("Train from scratch!")
            return
        own = self.state_dict()
        saved = read_checkpoint(self.pre_path, self)
        self.load_state_dict({k: v for k, v in saved.items() if k in own}, strict=False)
        logging.info("Load pretrained S3Rec from " + self.pre_path)
