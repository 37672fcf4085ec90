"""DirectAU -- representation alignment + uniformity for CF (port of
rechorus_tpu/models/general/directau.py).

Reference behavior: src/models/general/DirectAU.py (Wang et al., KDD'22):
plain MF scoring; loss = alignment (||u - i||^2 of the normalized
embeddings) + gamma * the mean of the two uniformity terms
log mean exp(-2 * pdist^2); trains WITHOUT negatives.
CMD example:
  python -m rechorus_tpu_torch.main --model_name DirectAU --emb_size 64 \
      --lr 1e-3 --l2 1e-5 --epoch 500 --gamma 0.3
"""
from __future__ import annotations

from typing import ClassVar

from rechorus_tpu_torch.models.base import GeneralModel
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import _glorot_normal, embed
from rechorus_tpu_torch.registry import register_model


@register_model("DirectAU")
class DirectAU(GeneralModel):
    batch_coupled: ClassVar[bool] = True   # uniformity over the batch
    train_with_neg: ClassVar[bool] = False
    extra_log_args: ClassVar[list] = ["emb_size", "gamma"]

    def __init__(self, *, emb_size: int = 64, gamma: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.gamma = emb_size, gamma
        self.u_embeddings = embed(self.user_num, emb_size, init=_glorot_normal)
        self.i_embeddings = embed(self.item_num, emb_size, init=_glorot_normal)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--gamma", type=float, default=1, help="Weight of the uniformity loss.")
        return GeneralModel.parse_model_args(parser)

    def forward(self, feed, training: bool = False, gen=None):
        user_e = self.u_embeddings(feed["user_id"])          # [B, d]
        item_e = self.i_embeddings(feed["item_id"])          # [B, C, d]
        out = {"prediction": (user_e[:, None, :] * item_e).sum(-1)}
        if training:
            out.update({"user_e": user_e, "item_e": item_e[:, 0]})
        return out

    def loss(self, out_dict, feed):
        user_e, item_e = out_dict["user_e"], out_dict["item_e"]
        align = losses.alignment_loss(user_e, item_e)
        uniform = (losses.uniformity_loss(user_e) + losses.uniformity_loss(item_e)) / 2
        return align + self.gamma * uniform
