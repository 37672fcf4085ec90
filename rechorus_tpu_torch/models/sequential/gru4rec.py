"""GRU4Rec -- session-based recommendation with a GRU (port of
rechorus_tpu/models/sequential/gru4rec.py: `GRU4Rec` and
`GRU4RecImpression`).

Reference behavior: src/models/sequential/GRU4Rec.py (Hidasi et al.,
ICLR'16): item emb -> GRU (packed in the reference; a fixed-shape loop
here) -> linear -> dot with candidate embeddings.
"""
from __future__ import annotations

from typing import ClassVar

from rechorus_tpu_torch.models.base import ImpressionSeqModel, SequentialModel
from rechorus_tpu_torch.ops.layers import Dense, MaskedGRU, embed
from rechorus_tpu_torch.registry import register_model


class GRU4RecBase:
    """The table, the GRU and its output layer, shared by GRU4Rec and
    GRU4RecImpression (JAX `GRU4RecBase`)."""

    def init_layers(self, emb_size: int, hidden_size: int) -> None:
        self.emb_size, self.hidden_size = emb_size, hidden_size
        self.i_embeddings = embed(self.item_num, emb_size)
        self.rnn = MaskedGRU(emb_size, hidden_size)
        self.out = Dense(hidden_size, emb_size)

    @staticmethod
    def parse_model_args_base(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--hidden_size", type=int, default=100, help="Size of hidden vectors in GRU.")
        return parser

    def encode(self, feed):
        _, hidden = self.rnn(self.i_embeddings(feed["history_items"]), feed["lengths"])
        return self.out(hidden)


@register_model("GRU4Rec")
class GRU4Rec(SequentialModel, GRU4RecBase):
    extra_log_args: ClassVar[list] = ["emb_size", "hidden_size"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, hidden_size: int = 100, **kwargs):
        super().__init__(**kwargs)
        self.init_layers(emb_size, hidden_size)

    @staticmethod
    def parse_model_args(parser):
        return SequentialModel.parse_model_args(GRU4RecBase.parse_model_args_base(parser))

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        rnn_vector = self.encode(feed)
        if catalog:
            return {"u_v": rnn_vector}
        pred_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (rnn_vector[:, None, :] * pred_vectors).sum(-1)}


@register_model("GRU4RecImpression")
class GRU4RecImpression(ImpressionSeqModel, GRU4RecBase):
    """Impression-mode GRU4Rec (reference GRU4Rec.py:93-106), with the
    re-rankers' 'u_v' and 'i_v'."""

    extra_log_args: ClassVar[list] = ["emb_size", "hidden_size"]

    def __init__(self, *, emb_size: int = 64, hidden_size: int = 100, **kwargs):
        super().__init__(**kwargs)
        self.init_layers(emb_size, hidden_size)

    @staticmethod
    def parse_model_args(parser):
        return ImpressionSeqModel.parse_model_args(GRU4RecBase.parse_model_args_base(parser))

    def forward(self, feed, training: bool = False, gen=None):
        rnn_vector = self.encode(feed)
        pred_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (rnn_vector[:, None, :] * pred_vectors).sum(-1),
                "u_v": rnn_vector[:, None, :].expand(pred_vectors.shape), "i_v": pred_vectors}
