"""CFKG -- collaborative filtering on knowledge-base embeddings, TransE
(port of rechorus_tpu/models/general/cfkg.py).

Reference behavior: src/models/general/CFKG.py (Zhang et al., SIGIR'18):
one entity table over [users | items + attribute entities], a relation
table whose index 0 is "buy"; score(h, r, t) = -||h + r - t||^2; the
margin ranking loss over the 4-column (h, h, h, h') x (t, t, t', t)
corruption built by the 'cfkg' batcher; training rows are the KG
triplets and the interactions. Its feeds are indexed by entity and carry
no `item_id`: the runner reports candidate columns as the items.
CMD example (its dev curve plateaus before it climbs: RESULTS.md asks for
--early_stop 40):
  python -m rechorus_tpu_torch.main --model_name CFKG --emb_size 64 --margin 1 \
      --include_attr 1 --lr 1e-4 --l2 1e-8 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

from rechorus_tpu_torch.models.base import GeneralModel
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import embed
from rechorus_tpu_torch.registry import register_model


@register_model("CFKG")
class CFKG(GeneralModel):
    reader: ClassVar[str] = "KGReader"
    batcher: ClassVar[str] = "cfkg"
    extra_log_args: ClassVar[list] = ["emb_size", "margin", "include_attr"]

    def __init__(self, *, emb_size: int = 64, margin: float = 0.0, entity_num: int = 0,
                 relation_num: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.margin = emb_size, margin
        self.entity_num, self.relation_num = entity_num, relation_num
        self.e_embeddings = embed(self.user_num + entity_num, emb_size)
        self.r_embeddings = embed(relation_num, emb_size)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--margin", type=float, default=0, help="Margin in hinge loss.")
        return GeneralModel.parse_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["entity_num"] = corpus.n_entities
        kw["relation_num"] = corpus.n_relations
        return kw

    def lazy_table_specs(self) -> dict:
        # the joint [users | entities] table is the big one; r_embeddings is
        # [n_relations, d] and stays dense
        return {"e_embeddings.weight": ("head_id", "tail_id")}

    def forward(self, feed, training: bool = False, gen=None):
        head = self.e_embeddings(feed["head_id"])
        tail = self.e_embeddings(feed["tail_id"])
        relation = self.r_embeddings(feed["relation_id"])
        return {"prediction": -((head + relation - tail) ** 2).sum(-1)}

    def loss(self, out_dict, feed):
        predictions = out_dict["prediction"]                 # [B, 4]
        # nn.MarginRankingLoss(margin)(pos, neg, +1)
        return losses.margin_rank_loss(predictions[:, :2].reshape(-1),
                                       predictions[:, 2:].reshape(-1), self.margin)
