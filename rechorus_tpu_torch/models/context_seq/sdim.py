"""SDIM -- sampling-based deep interest modeling through LSH bucket
collisions (port of rechorus_tpu/models/context_seq/sdim.py).

Reference behavior: src/models/context_seq/SDIM.py (FuxiCTR-derived, an
ETA subclass): the long-history interest is the sum of the history
embeddings whose LSH bucket collides with the target's, averaged over the
hashes; the short part is ETA's target attention. As in the JAX package,
the collision sum excludes padded positions (the reference's
embedding_bag path counts pad collisions, SDIM.py:114-131), and it is one
product over a [B, C, H, num_hashes] collision mask instead of
nonzero + embedding_bag.
"""
from __future__ import annotations

from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import ContextSeqCTRModel, ContextSeqModel
from rechorus_tpu_torch.models.context_seq.eta import ETABase
from rechorus_tpu_torch.registry import register_model


class SDIMBase(ETABase):
    LONG_ATTENTION: ClassVar[bool] = False

    def has_short(self) -> bool:
        return self.recent_k > 0

    def lsh_attention(self, rotations, target, sequence, mask):
        """target [B, C, D], sequence [B, H, D], mask [B, H] -> [B, C, D]."""
        seq_bucket = self.lsh_hash(sequence, rotations)                         # [B, H, nh]
        tgt_bucket = self.lsh_hash(target, rotations)                           # [B, C, nh]
        collide = (tgt_bucket[:, :, None, :] == seq_bucket[:, None, :, :]) & mask[:, None, :, None]
        return torch.einsum("bchn,bhd->bcnd", collide.to(sequence.dtype), sequence).mean(dim=2)

    def long_feature(self, i, rotations, t, s, mask_long, training, gen):
        return self.lsh_attention(rotations, t, s, mask_long)


@register_model("SDIMCTR")
class SDIMCTR(SDIMBase, ContextSeqCTRModel):
    pass


@register_model("SDIMTopK")
class SDIMTopK(SDIMBase, ContextSeqModel):
    pass
