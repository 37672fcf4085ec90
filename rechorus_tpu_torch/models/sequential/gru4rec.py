"""GRU4Rec -- session-based recommendation with a GRU (port of
rechorus_tpu/models/sequential/gru4rec.py:19-61, `GRU4Rec` only).

Reference behavior: src/models/sequential/GRU4Rec.py (Hidasi et al.,
ICLR'16): item emb -> GRU (packed in the reference; a fixed-shape loop
here) -> linear -> dot with candidate embeddings.
"""
from __future__ import annotations

from typing import ClassVar

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import Dense, MaskedGRU, embed
from rechorus_tpu_torch.registry import register_model


@register_model("GRU4Rec")
class GRU4Rec(SequentialModel):
    extra_log_args: ClassVar[list] = ["emb_size", "hidden_size"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, hidden_size: int = 100, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.hidden_size = emb_size, hidden_size
        self.i_embeddings = embed(self.item_num, emb_size)
        self.rnn = MaskedGRU(emb_size, hidden_size)
        self.out = Dense(hidden_size, emb_size)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--hidden_size", type=int, default=100, help="Size of hidden vectors in GRU.")
        return SequentialModel.parse_model_args(parser)

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        _, hidden = self.rnn(self.i_embeddings(feed["history_items"]), feed["lengths"])
        rnn_vector = self.out(hidden)
        if catalog:
            return {"u_v": rnn_vector}
        pred_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (rnn_vector[:, None, :] * pred_vectors).sum(-1)}
