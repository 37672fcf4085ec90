"""NARM -- neural attentive session-based recommendation (port of
rechorus_tpu/models/sequential/narm.py).

Reference behavior: src/models/sequential/NARM.py (Li et al., CIKM'17):
global GRU final state + local GRU outputs attended (sigmoid MLP
attention, masked by history > 0), concatenated -> linear -> dot with
candidates.
"""
from __future__ import annotations

from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import Dense, MaskedGRU, embed
from rechorus_tpu_torch.registry import register_model


@register_model("NARM")
class NARM(SequentialModel):
    extra_log_args: ClassVar[list] = ["emb_size", "hidden_size", "attention_size"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, hidden_size: int = 100, attention_size: int = 50,
                 **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.hidden_size, self.attention_size = emb_size, hidden_size, attention_size
        self.i_embeddings = embed(self.item_num, emb_size)
        self.encoder_g = MaskedGRU(emb_size, hidden_size)
        self.encoder_l = MaskedGRU(emb_size, hidden_size)
        self.A1 = Dense(hidden_size, attention_size, use_bias=False)
        self.A2 = Dense(hidden_size, attention_size, use_bias=False)
        self.attention_out = Dense(attention_size, 1, use_bias=False)
        self.out = Dense(2 * hidden_size, emb_size, use_bias=False)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--hidden_size", type=int, default=100, help="Size of hidden vectors in GRU.")
        parser.add_argument("--attention_size", type=int, default=50, help="Size of attention hidden space.")
        return SequentialModel.parse_model_args(parser)

    def encode(self, feed):
        history, lengths = feed["history_items"], feed["lengths"]
        his_vectors = self.i_embeddings(history)
        _, hidden_g = self.encoder_g(his_vectors, lengths)
        output_l, _ = self.encoder_l(his_vectors, lengths)
        attention_g = self.A1(hidden_g)
        attention_l = self.A2(output_l)
        attention_value = self.attention_out(torch.sigmoid(attention_g[:, None, :] + attention_l))
        attention_value = attention_value * (history > 0)[:, :, None]
        c_l = (attention_value * output_l).sum(1)
        return self.out(torch.cat([hidden_g, c_l], dim=1))

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        pred_vector = self.encode(feed)
        if catalog:
            return {"u_v": pred_vector}
        i_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (pred_vector[:, None, :] * i_vectors).sum(-1)}
