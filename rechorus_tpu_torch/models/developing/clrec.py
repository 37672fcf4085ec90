"""CLRec -- contrastive learning for sequential recommendation (port of
rechorus_tpu/models/developing/clrec.py).

Reference behavior: src/models/developing/CLRec.py: a 2-layer, 2-head
BERT4Rec encoder; training draws NO negatives -- the loss is the
one-directional InfoNCE between the L2-normalised sequence state (view 0)
and the target item's embedding (view 1), the other rows' targets in the
batch being the negatives (ContraLoss, CLRec.py:70-109). It has no
catalog protocol: full-catalog evaluation goes through its forward.
CMD example:
  python -m rechorus_tpu_torch.main --model_name CLRec --emb_size 64 --lr 1e-3 --l2 1e-6 \
      --history_max 20 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

import torch
import torch.nn.functional as F

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.models.sequential.contrarec import BERT4RecEncoder
from rechorus_tpu_torch.ops.layers import embed
from rechorus_tpu_torch.registry import register_model


@register_model("CLRec")
class CLRec(SequentialModel):
    batch_coupled: ClassVar[bool] = True   # in-batch InfoNCE
    train_with_neg: ClassVar[bool] = False
    extra_log_args: ClassVar[list] = ["batch_size", "temp"]

    def __init__(self, *, emb_size: int = 64, temp: float = 0.2, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.temp = emb_size, temp
        self.i_embeddings = embed(self.item_num, emb_size)
        self.encoder = BERT4RecEncoder(emb_size, self.history_max, num_layers=2, num_heads=2)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--temp", type=float, default=0.2, help="Temperature in contrastive loss.")
        return SequentialModel.parse_model_args(parser)

    def forward(self, feed, training: bool = False, gen=None):
        his_vector = self.encoder(self.i_embeddings(feed["history_items"]), feed["lengths"],
                                  training=training, gen=gen)
        i_vectors = self.i_embeddings(feed["item_id"])
        out = {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}
        if training:
            features = torch.stack([his_vector, i_vectors[:, 0, :]], dim=1)
            out["features"] = features / torch.linalg.vector_norm(
                features, dim=-1, keepdim=True).clamp_min(1e-12)
        return out

    def loss(self, out_dict, feed):
        f = out_dict["features"]
        logits = (f[:, 0] @ f[:, 1].T) / self.temp                         # [B, B]
        return -torch.diagonal(F.log_softmax(logits, dim=1)).mean()
