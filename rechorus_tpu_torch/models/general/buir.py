"""BUIR -- Bootstrapping User and Item Representations, one-class CF (port
of rechorus_tpu/models/general/buir.py).

Reference behavior: src/models/general/BUIR.py (Lee et al., SIGIR'21):
online and target twin embedding tables and a linear predictor; the
BYOL-style loss 2 - 2 * cos(online, target) with no gradient into the
targets; the targets follow the online tables by an EMA (momentum) after
every optimizer step (`runners.buir.BUIRRunner`); trains WITHOUT
negatives.

The target tables are buffers of the module (in the state_dict, so a
checkpoint and the best epoch carry them), copied from the online tables
at init (`post_init_state`) and updated in place by `ema_update`.
CMD example:
  python -m rechorus_tpu_torch.main --model_name BUIR --emb_size 64 --lr 1e-3 \
      --l2 1e-6 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import GeneralModel
from rechorus_tpu_torch.ops.layers import Dense, _glorot_normal, _unit_normal, embed
from rechorus_tpu_torch.parallel.mesh import pad_rows
from rechorus_tpu_torch.registry import register_model


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@register_model("BUIR")
class BUIR(GeneralModel):
    runner: ClassVar[str] = "BUIRRunner"
    train_with_neg: ClassVar[bool] = False
    extra_log_args: ClassVar[list] = ["emb_size", "momentum"]

    def __init__(self, *, emb_size: int = 64, momentum: float = 0.995, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.momentum = emb_size, momentum
        self.user_online = embed(self.user_num, emb_size, init=_glorot_normal)
        self.item_online = embed(self.item_num, emb_size, init=_glorot_normal)
        # reference init_weights: Linear weight xavier_normal, bias N(0, 1)
        self.predictor = Dense(emb_size, emb_size, kernel_init=_glorot_normal,
                               bias_init=_unit_normal)
        # the targets are replicated (the JAX package's `target` collection
        # is no parameter, so it never row-shards) at the online tables' rows
        self.register_buffer("user_target", torch.zeros(pad_rows(self.user_num), emb_size))
        self.register_buffer("item_target", torch.zeros(pad_rows(self.item_num), emb_size))
        self.live_rows = {"user_target": self.user_num, "item_target": self.item_num}

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--momentum", type=float, default=0.995, help="Momentum update.")
        return GeneralModel.parse_model_args(parser)

    def lazy_table_specs(self) -> dict:
        # the online twins only: the EMA of the targets is a whole-table op
        # after the step, not an optimizer update
        return {"user_online.weight": ("user_id",), "item_online.weight": ("item_id",)}

    def forward(self, feed, training: bool = False, gen=None):
        user, items = feed["user_id"], feed["item_id"]
        u_on = self.user_online(user)                                # [B, d]
        i_on = self.item_online(items)                               # [B, C, d]
        prediction = (self.predictor(i_on) * u_on[:, None, :]).sum(-1) + \
            (self.predictor(u_on)[:, None, :] * i_on).sum(-1)
        out = {"prediction": prediction}
        if training:
            out.update({"u_online": self.predictor(u_on), "u_target": self.user_target[user],
                        "i_online": self.predictor(i_on[:, 0]),
                        "i_target": self.item_target[items[:, 0]]})
        return out

    def loss(self, out_dict, feed):
        u_on, i_on = _normalize(out_dict["u_online"]), _normalize(out_dict["i_online"])
        u_t, i_t = _normalize(out_dict["u_target"]), _normalize(out_dict["i_target"])
        loss_ui = 2 - 2 * (u_on * i_t).sum(-1)
        loss_iu = 2 - 2 * (i_on * u_t).sum(-1)
        return (loss_ui + loss_iu).mean()

    # -- BUIRRunner hooks ------------------------------------------------
    @torch.no_grad()
    def post_init_state(self) -> None:
        """The targets start as copies of the online tables (reference
        BUIR.py:50-56); the runner calls this after drawing the weights."""
        self.user_target = self.user_online.full().detach().clone()
        self.item_target = self.item_online.full().detach().clone()

    @torch.no_grad()
    def ema_update(self) -> None:
        """target <- target * m + online * (1 - m), in place."""
        m = self.momentum
        for target, online in ((self.user_target, self.user_online.full()),
                               (self.item_target, self.item_online.full())):
            target.mul_(m).add_(online * (1.0 - m))
