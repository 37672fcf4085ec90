"""NeuMF (NCF) -- GMF tower || MLP tower -> linear head (port of
rechorus_tpu/models/general/neumf.py).

Reference behavior: src/models/general/NeuMF.py (He et al., WWW'17).
CMD example:
  python -m rechorus_tpu_torch.main --model_name NeuMF --emb_size 64 --layers '[64]' \
      --lr 5e-4 --l2 1e-7 --dropout 0.2 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import GeneralModel
from rechorus_tpu_torch.ops.layers import Dense, dropout, embed
from rechorus_tpu_torch.registry import register_model


@register_model("NeuMF")
class NeuMF(GeneralModel):
    extra_log_args: ClassVar[list] = ["emb_size", "layers"]

    def __init__(self, *, emb_size: int = 64, layers=(64,), **kwargs):
        super().__init__(**kwargs)
        self.emb_size = emb_size
        self.layers = tuple(layers)
        self.mf_u_embeddings = embed(self.user_num, emb_size)
        self.mf_i_embeddings = embed(self.item_num, emb_size)
        self.mlp_u_embeddings = embed(self.user_num, emb_size)
        self.mlp_i_embeddings = embed(self.item_num, emb_size)
        width = 2 * emb_size
        for k, size in enumerate(self.layers):
            self.add_module(f"mlp_{k}", Dense(width, size))
            width = size
        self.prediction = Dense(emb_size + width, 1, use_bias=False)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--layers", type=str, default="[64]", help="Size of each layer.")
        return GeneralModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["layers"] = tuple(ast.literal_eval(args.layers))
        return kw

    def lazy_table_specs(self) -> dict:
        # the twin MF / MLP tables, all gathered by user_id / item_id only
        return {
            "mf_u_embeddings.weight": ("user_id",),
            "mlp_u_embeddings.weight": ("user_id",),
            "mf_i_embeddings.weight": ("item_id",),
            "mlp_i_embeddings.weight": ("item_id",),
        }

    def forward(self, feed, training: bool = False, gen=None):
        """feed["user_id"] [B]; feed["item_id"] [B, C] -> {"prediction": [B, C]}."""
        i_ids = feed["item_id"]
        u_ids = feed["user_id"][:, None].expand(i_ids.shape)
        mf_vector = self.mf_u_embeddings(u_ids) * self.mf_i_embeddings(i_ids)
        mlp_vector = torch.cat([self.mlp_u_embeddings(u_ids), self.mlp_i_embeddings(i_ids)], dim=-1)
        for k in range(len(self.layers)):
            mlp_vector = torch.relu(getattr(self, f"mlp_{k}")(mlp_vector))
            mlp_vector = dropout(mlp_vector, self.dropout, training, gen)
        output = torch.cat([mf_vector, mlp_vector], dim=-1)
        return {"prediction": self.prediction(output)[..., 0]}
