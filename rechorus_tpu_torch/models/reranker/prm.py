"""PRM -- personalized re-ranking model (port of
rechorus_tpu/models/reranker/prm.py).

Reference behavior: src/models/reranker/PRM.py (Pei et al., RecSys'19):
input per candidate = [re-ranker item emb | ranker u_v | ranker i_v] + a
learned ordinal position embedding (by the ranker-score rank), a
transformer encoder stack with the key-padding mask, a linear head. Modes:
PRMGeneral (ImpressionReader) and PRMSequential (ImpressionSeqReader).
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.models.base import RerankModel, RerankSeqModel
from rechorus_tpu_torch.ops.layers import Dense, TransformerLayer, embed
from rechorus_tpu_torch.registry import register_model


class PRMBase:
    @staticmethod
    def parse_model_args_prm(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of item embedding vectors.")
        parser.add_argument("--n_blocks", type=int, default=4, help="num of transformer blocks")
        parser.add_argument("--num_heads", type=int, default=4, help="Number of attention heads.")
        parser.add_argument("--num_hidden_unit", type=int, default=64, help="Hidden units in Transformer layer.")
        return parser

    def init_prm(self, emb_size: int, n_blocks: int, num_heads: int, num_hidden_unit: int) -> None:
        self.emb_size, self.n_blocks = emb_size, n_blocks
        self.num_heads, self.num_hidden_unit = num_heads, num_hidden_unit
        d_in = emb_size + 2 * self.ranker_emb_size
        self.i_embeddings = embed(self.item_num, emb_size)
        # sized by the larger of the train / test caps, as in the JAX package
        # (the reference sizes it by the train caps only)
        self.ordinal_position_embedding = embed(
            max(self.train_max_pos_item + self.train_max_neg_item,
                self.test_max_pos_item + self.test_max_neg_item), d_in)
        self.rFF0 = Dense(d_in, num_hidden_unit)
        for k in range(n_blocks):
            self.add_module(f"encoder_{k}", TransformerLayer(
                num_hidden_unit, 128, num_heads, dropout=self.dropout, kq_same=False, out_proj=True))
        self.rFF1 = Dense(num_hidden_unit, 1)

    def forward(self, feed, training: bool = False, gen=None):
        feed = self.rerank_feed(feed)       # the ranker's keys (run here under --tuneranker)
        i_vectors = self.i_embeddings(feed["item_id"])                        # [B, L, e]
        di = torch.cat([i_vectors, feed["u_v"], feed["i_v"]], dim=2)
        xi = self.rFF0(di + self.ordinal_position_embedding(feed["position"]))
        attend = (~feed["padding_mask"])[:, None, None, :]                    # [B, 1, 1, L]
        for k in range(self.n_blocks):
            xi = getattr(self, f"encoder_{k}")(xi, mask=attend, training=training, gen=gen)
        return {"prediction": self.rFF1(xi)[..., 0]}


@register_model("PRMGeneral")
class PRMGeneral(RerankModel, PRMBase):
    def __init__(self, *, emb_size: int = 64, n_blocks: int = 4, num_heads: int = 4,
                 num_hidden_unit: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.init_prm(emb_size, n_blocks, num_heads, num_hidden_unit)

    @staticmethod
    def parse_model_args(parser):
        return RerankModel.parse_model_args(PRMBase.parse_model_args_prm(parser))

    forward = PRMBase.forward


@register_model("PRMSequential")
class PRMSequential(RerankSeqModel, PRMBase):
    def __init__(self, *, emb_size: int = 64, n_blocks: int = 4, num_heads: int = 4,
                 num_hidden_unit: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.init_prm(emb_size, n_blocks, num_heads, num_hidden_unit)

    @staticmethod
    def parse_model_args(parser):
        return RerankSeqModel.parse_model_args(PRMBase.parse_model_args_prm(parser))

    forward = PRMBase.forward
