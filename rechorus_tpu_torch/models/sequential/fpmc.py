"""FPMC -- factorized personalized Markov chains (port of
rechorus_tpu/models/sequential/fpmc.py).

Reference behavior: src/models/sequential/FPMC.py (Rendle et al., WWW'10):
MF term dot(UI[u], IU[i]) + first-order transition term dot(LI[last],
IL[i]). The last item comes from the fixed-shape history arrays (last
valid position), as in the JAX package.
"""
from __future__ import annotations

from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import embed
from rechorus_tpu_torch.parallel.mesh import shard_of
from rechorus_tpu_torch.registry import register_model


@register_model("FPMC")
class FPMC(SequentialModel):
    extra_log_args: ClassVar[list] = ["emb_size"]
    supports_catalog: ClassVar[bool] = True
    catalog_raw_table: ClassVar[bool] = False   # scores against [iu | il]

    def __init__(self, *, emb_size: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.emb_size = emb_size
        self.ui_embeddings = embed(self.user_num, emb_size)
        self.iu_embeddings = embed(self.item_num, emb_size)
        self.li_embeddings = embed(self.item_num, emb_size)
        self.il_embeddings = embed(self.item_num, emb_size)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        return SequentialModel.parse_model_args(parser)

    def lazy_table_specs(self) -> dict:
        # the 'last item' li-gather draws from history_items values
        return {
            "ui_embeddings.weight": ("user_id",),
            "iu_embeddings.weight": ("item_id",),
            "il_embeddings.weight": ("item_id",),
            "li_embeddings.weight": ("history_items",),
        }

    def catalog_item_table(self, local: bool = False) -> torch.Tensor:
        """[N, 2D] = [iu | il] over all items: score = ui . iu[i] + li .
        il[i] = [ui | li] . [iu | il][i] (the JAX model's `i_table`). With
        `local`, this rank's row block of it (both tables row-shard alike)."""
        get = (lambda t: t.weight) if local else (lambda t: t.full())
        return torch.cat([get(self.iu_embeddings).detach().float(),
                          get(self.il_embeddings).detach().float()], dim=1).contiguous()

    def catalog_shard(self):
        return shard_of(self.iu_embeddings.weight)

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        history, lengths = feed["history_items"], feed["lengths"]
        li_id = history.gather(1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
        ui = self.ui_embeddings(feed["user_id"])
        li = self.li_embeddings(li_id)
        if catalog:
            return {"u_v": torch.cat([ui, li], dim=-1)}
        iu = self.iu_embeddings(feed["item_id"])
        il = self.il_embeddings(feed["item_id"])
        return {"prediction": (ui[:, None, :] * iu).sum(-1) + (li[:, None, :] * il).sum(-1)}
