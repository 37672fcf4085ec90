"""BPRMF -- Bayesian Personalized Ranking matrix factorization (port of
rechorus_tpu/models/general/bprmf.py:22-55; the Impression variant comes
with its runner).

prediction = dot(u_emb[user], i_emb[items]) (Rendle et al., UAI'09;
reference src/models/general/BPRMF.py).
CMD example:
  python -m rechorus_tpu_torch.main --model_name BPRMF --emb_size 64 --lr 1e-3 \
      --l2 1e-6 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

from rechorus_tpu_torch.models.base import GeneralModel
from rechorus_tpu_torch.ops.layers import embed
from rechorus_tpu_torch.registry import register_model


@register_model("BPRMF")
class BPRMF(GeneralModel):
    extra_log_args: ClassVar[list] = ["emb_size", "batch_size"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.emb_size = emb_size
        self.u_embeddings = embed(self.user_num, emb_size)
        self.i_embeddings = embed(self.item_num, emb_size)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        return GeneralModel.parse_model_args(parser)

    def forward(self, feed, catalog: bool = False):
        """feed["user_id"] [B]; feed["item_id"] [B, C]. Returns
        {"prediction": [B, C]}, or {"u_v": [B, D]} with catalog=True."""
        u_v = self.u_embeddings(feed["user_id"])
        if catalog:
            return {"u_v": u_v}
        i_v = self.i_embeddings(feed["item_id"])
        return {"prediction": (u_v[:, None, :] * i_v).sum(-1)}
