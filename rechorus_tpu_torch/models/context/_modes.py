"""The CTR / TopK mode-class pattern of the context models (port of
rechorus_tpu/models/context/_modes.py).

Each model file defines one mixin (its hyperparameters in `__init__`, its
CLI flags in `add_model_args`, its score in `prediction`) and registers it
twice: `<Name>CTR` over `ContextCTRModel` and `<Name>TopK` over
`ContextModel` (the context_seq models: over `ContextSeqCTRModel` and
`ContextSeqModel`). The mixin comes first in the bases, so `ContextHead`'s
`forward`, `loss` and `parse_model_args` are the ones that run, and the
mode's base comes last.
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.models.base import CTRModel


def ctr_out(prediction, feed):
    """A raw [B, 1] score in the CTR contract: sigmoid + label, both [B]."""
    return {"prediction": torch.sigmoid(prediction.reshape(-1)), "label": feed["label"].reshape(-1)}


def mode_out(model, prediction, feed):
    """[B, C] scores in the model's mode: `ctr_out` for a CTR model, the
    scores for a TopK one."""
    return ctr_out(prediction, feed) if isinstance(model, CTRModel) else {"prediction": prediction}


class ContextHead:
    """`prediction(feed, training, gen) -> ([B, C] scores, reg or None)`
    becomes the mode's output: CTR models return the sigmoid and the
    labels, TopK models the scores; a model with a regulariser adds
    `reg_loss` = reg_weight * reg to the output and to the loss (the JAX
    package's pure loss functions read it from there)."""

    def forward(self, feed, training: bool = False, gen=None):
        pred, reg = self.prediction(feed, training, gen)
        out = mode_out(self, pred, feed)
        if reg is not None:
            out["reg_loss"] = self.reg_weight * reg
        return out

    def loss(self, out_dict, feed):
        base = super().loss(out_dict, feed)
        return base + out_dict["reg_loss"] if "reg_loss" in out_dict else base

    @classmethod
    def parse_model_args(cls, parser):
        return cls.__bases__[-1].parse_model_args(cls.add_model_args(parser))

    def flat_embeddings(self, feed):
        """The bank's [B, C, F * d] embeddings of the feed's candidates."""
        v = self.bank(*self.context_inputs(feed))
        return v.reshape(v.shape[0], v.shape[1], -1)

    def linear_part(self, feed):
        """(embeddings [B, C, F, d], overall_bias + the linear terms [B, C])
        of a bank with linear terms."""
        v, lin = self.bank(*self.context_inputs(feed))
        return v, self.overall_bias + lin.sum(-1)


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """The FM second-order term of [..., F, d] embeddings: sum over d of
    0.5 * ((sum_F v)^2 - sum_F v^2)."""
    return (0.5 * (v.sum(-2) ** 2 - (v ** 2).sum(-2))).sum(-1)
