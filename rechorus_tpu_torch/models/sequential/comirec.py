"""ComiRec -- controllable multi-interest sequential recommendation (port
of rechorus_tpu/models/sequential/comirec.py).

Reference behavior: src/models/sequential/ComiRec.py (Cen et al., KDD'20):
K attention heads over the history give K interest vectors; training
scores with the interest closest to the target, evaluation takes the max
over the interests per candidate. As in the JAX package, the target is the
TRUE target (the feed's `_target_col` after the runner's anti-leak
permutation; the reference takes column 0 of the permuted candidates).
Its catalog protocol is the multi-interest one (`BaseModel.multi_interest`):
`forward(feed, catalog=True)` returns the K interests as `u_v` [B, K, d],
and full-catalog evaluation scores an item by their max through the
catalog routes (ops.topk, `rtt_interest_ge_kernel` at catalog scale).
CMD example:
  python -m rechorus_tpu_torch.main --model_name ComiRec --emb_size 64 --lr 1e-3 --l2 1e-6 \
      --attn_size 8 --K 4 --add_pos 1 --history_max 20 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import SequentialModel, target_col
from rechorus_tpu_torch.ops.layers import Dense, embed
from rechorus_tpu_torch.ops.losses import masked_softmax
from rechorus_tpu_torch.registry import register_model
from rechorus_tpu_torch.utils.spans import span


def target_vectors(feed, i_vectors):
    """[B, d] rows of the true target (`target_col`) in `i_vectors` [B, C, d]."""
    tcol = target_col(feed)
    return i_vectors.gather(1, tcol[:, None, None].expand(-1, 1, i_vectors.shape[2]))[:, 0]


def closest_interest(interest_vectors, target_vector):
    """[B, d] interest of `interest_vectors` [B, K, d] with the largest dot
    product with `target_vector` [B, d] (the first on a tie)."""
    idx = (interest_vectors * target_vector[:, None, :]).sum(-1).argmax(-1)
    return interest_vectors.gather(1, idx[:, None, None].expand(-1, 1, interest_vectors.shape[2]))[:, 0]


@register_model("ComiRec")
class ComiRec(SequentialModel):
    extra_log_args: ClassVar[list] = ["emb_size", "attn_size", "K"]
    supports_catalog: ClassVar[bool] = True
    multi_interest: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, attn_size: int = 8, K: int = 2, add_pos: int = 1,
                 **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.attn_size, self.K, self.add_pos = emb_size, attn_size, K, add_pos
        self.i_embeddings = embed(self.item_num, emb_size)
        if add_pos:
            self.p_embeddings = embed(self.history_max + 1, emb_size)
        self.W1 = Dense(emb_size, attn_size)
        self.W2 = Dense(attn_size, K)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--attn_size", type=int, default=8, help="Size of attention vectors.")
        parser.add_argument("--K", type=int, default=2, help="Number of hidden intent.")
        parser.add_argument("--add_pos", type=int, default=1, help="Whether add position embedding.")
        return SequentialModel.parse_model_args(parser)

    def forward(self, feed, training: bool = False, gen=None, catalog: bool = False):
        """{"prediction": [B, C]}, or {"u_v": [B, K, d]} (the interests)
        with catalog=True."""
        if catalog:
            with span("model.interests"):
                return {"u_v": self.interests(feed)}
        interests = self.interests(feed)
        i_vectors = self.i_embeddings(feed["item_id"])
        if training:
            user_vector = closest_interest(interests, target_vectors(feed, i_vectors))
            prediction = (user_vector[:, None, :] * i_vectors).sum(-1)
        else:
            prediction = (interests[:, None, :, :] * i_vectors[:, :, None, :]).sum(-1).amax(-1)
        return {"prediction": prediction}

    def interests(self, feed):
        """[B, K, d]: K attention heads over the history, each a weighted
        sum of the history's item vectors."""
        history, lengths = feed["history_items"], feed["lengths"]
        L = history.shape[1]
        valid = history > 0
        his_vectors = self.i_embeddings(history)
        his_pos = his_vectors
        if self.add_pos:
            position = (lengths[:, None] - torch.arange(L, device=history.device)[None, :]) * valid
            his_pos = his_vectors + self.p_embeddings(position)
        attn = self.W2(torch.tanh(self.W1(his_pos))).transpose(-1, -2)   # [B, K, L]
        attn = masked_softmax(attn, valid[:, None, :], dim=-1)
        return (his_vectors[:, None, :, :] * attn[:, :, :, None]).sum(-2)   # [B, K, d]
