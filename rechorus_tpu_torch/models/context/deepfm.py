"""DeepFM -- FM + a deep tower over the shared embeddings, predictions
summed (port of rechorus_tpu/models/context/deepfm.py).

Reference behavior: src/models/context/DeepFM.py (Guo et al., IJCAI'17).
"""
from __future__ import annotations

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import fm_interaction
from rechorus_tpu_torch.models.context.widedeep import WideDeepBase
from rechorus_tpu_torch.registry import register_model


class DeepFMBase(WideDeepBase):
    def prediction(self, feed, training, gen):
        v, linear = self.linear_part(feed)
        return fm_interaction(v) + linear + self.deep(v, training, gen), None


@register_model("DeepFMCTR")
class DeepFMCTR(DeepFMBase, ContextCTRModel):
    pass


@register_model("DeepFMTopK")
class DeepFMTopK(DeepFMBase, ContextModel):
    pass
