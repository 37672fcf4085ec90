"""SASRec -- self-attentive sequential recommendation (port of
rechorus_tpu/models/sequential/sasrec.py: `SASRec` and `SASRecImpression`).

Reference behavior: src/models/sequential/SASRec.py (Kang & McAuley,
ICDM'18): item + reversed-position embeddings, causal mask, post-LN
transformer stack, state at position lengths-1 dotted with candidates.
CMD example:
  python -m rechorus_tpu_torch.main --model_name SASRec --emb_size 64 --num_layers 1 \
      --num_heads 1 --lr 1e-4 --l2 1e-6 --history_max 20 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import ImpressionSeqModel, SequentialModel
from rechorus_tpu_torch.ops.layers import TransformerLayer, embed
from rechorus_tpu_torch.registry import register_model


class SASRecBase:
    """The tables, the transformer stack and the history encoder, shared by
    SASRec and SASRecImpression (JAX `SASRecBase`)."""

    def init_layers(self, emb_size: int, num_layers: int, num_heads: int) -> None:
        self.emb_size, self.num_layers, self.num_heads = emb_size, num_layers, num_heads
        self.i_embeddings = embed(self.item_num, emb_size)
        self.p_embeddings = embed(self.history_max + 1, emb_size)
        for k in range(num_layers):
            self.add_module(f"transformer_{k}", TransformerLayer(
                emb_size, emb_size, num_heads, dropout=self.dropout, kq_same=False))

    @staticmethod
    def parse_model_args_base(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--num_layers", type=int, default=1, help="Number of self-attention layers.")
        parser.add_argument("--num_heads", type=int, default=4, help="Number of attention heads.")
        return parser

    def encode(self, feed, training: bool, gen):
        """[B, D] state at position lengths - 1 of the history stack."""
        history, lengths = feed["history_items"], feed["lengths"]
        B, L = history.shape
        valid = history > 0
        his = self.i_embeddings(history)
        # reversed positions: lengths=4 -> [4,3,2,1,0,...] masked by validity
        position = (lengths[:, None] - torch.arange(L, device=history.device)[None, :]) * valid
        his = his + self.p_embeddings(position)
        causal = torch.ones((L, L), dtype=torch.bool, device=history.device).tril()
        for k in range(self.num_layers):
            his = getattr(self, f"transformer_{k}")(his, mask=causal, training=training, gen=gen)
        his = his * valid[:, :, None]
        last = (lengths - 1).clamp(min=0)
        return his.gather(1, last[:, None, None].expand(B, 1, his.shape[2]))[:, 0]


@register_model("SASRec")
class SASRec(SequentialModel, SASRecBase):
    extra_log_args: ClassVar[list] = ["emb_size", "num_layers", "num_heads"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, num_layers: int = 1, num_heads: int = 4, **kwargs):
        super().__init__(**kwargs)
        self.init_layers(emb_size, num_layers, num_heads)

    @staticmethod
    def parse_model_args(parser):
        return SequentialModel.parse_model_args(SASRecBase.parse_model_args_base(parser))

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        his_vector = self.encode(feed, training, gen)
        if catalog:
            return {"u_v": his_vector}
        i_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}


@register_model("SASRecImpression")
class SASRecImpression(ImpressionSeqModel, SASRecBase):
    """Impression-mode SASRec (reference SASRec.py:107-122), with the
    re-rankers' 'u_v' and 'i_v'."""

    extra_log_args: ClassVar[list] = ["emb_size", "num_layers", "num_heads"]

    def __init__(self, *, emb_size: int = 64, num_layers: int = 1, num_heads: int = 4, **kwargs):
        super().__init__(**kwargs)
        self.init_layers(emb_size, num_layers, num_heads)

    @staticmethod
    def parse_model_args(parser):
        return ImpressionSeqModel.parse_model_args(SASRecBase.parse_model_args_base(parser))

    def forward(self, feed, training: bool = False, gen=None):
        his_vector = self.encode(feed, training, gen)
        i_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1),
                "u_v": his_vector[:, None, :].expand(i_vectors.shape), "i_v": i_vectors}
