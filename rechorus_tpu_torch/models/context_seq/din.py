"""DIN -- deep interest network: target attention over the user's history
(port of rechorus_tpu/models/context_seq/din.py).

Reference behavior: src/models/context_seq/DIN.py (Zhou et al., KDD'18;
RecBole SequenceAttLayer-derived): an attention MLP over [q, k, q - k,
q * k] with sigmoid activations gives unnormalised weights (no softmax,
masked to 0), divided by sqrt(d); a Dice-activated DNN with BatchNorm on
[attended history, its product with the target, all context fields]. The
attention runs over the candidate axis by broadcasting, where the
reference repeats the history per candidate (DIN.py:147-160).
"""
from __future__ import annotations

import ast
import math
from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import ContextSeqCTRModel, ContextSeqModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops import layers
from rechorus_tpu_torch.ops.layers import MLPBlock
from rechorus_tpu_torch.registry import register_model


def group_widths(model) -> tuple:
    """(fields of the item, user and situation groups, fields of a history
    step and of a candidate's target: the item group, plus the situation
    group with --add_historical_situations 1)."""
    user_names, item_names, situ_names = model.source_names
    fi, fu, fs = len(item_names) + 1, len(user_names) + 1, len(situ_names)
    with_situ = fi + fs if model.add_historical_situations and fs else fi
    return fi, fu, fs, with_situ


def broadcast_candidates(x, C: int):
    """[B, ...] -> [B, C, ...] (a view)."""
    return x[:, None].expand((x.shape[0], C) + tuple(x.shape[1:]))


def sequence_embeddings(model, g):
    """(history [B, H, D], target [B, C, D]): the item groups flattened,
    each with its situation fields when the history carries them."""
    B, C = g["item"].shape[:2]
    H = g["history"].shape[1]
    if model.add_historical_situations and "history_situ" in g:
        history = torch.cat([g["history"], g["history_situ"]], dim=-2).reshape(B, H, -1)
        target = torch.cat([g["item"], broadcast_candidates(g["situ"], C)], dim=-2).reshape(B, C, -1)
        return history, target
    return g["history"].reshape(B, H, -1), g["item"].reshape(B, C, -1)


class DINBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "att_layers", "add_historical_situations"]

    def __init__(self, *, emb_size: int = 64, att_layers=(64,), dnn_layers=(64,), **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.att_layers, self.dnn_layers = emb_size, tuple(att_layers), tuple(dnn_layers)
        self.init_group_embeddings(emb_size)
        fi, fu, fs, fh = group_widths(self)
        D = fh * emb_size
        self.att_mlp_layers = MLPBlock(4 * D, self.att_layers, "Sigmoid", output_dim=1,
                                       dropout_rate=self.dropout)
        self.dnn_mlp_layers = MLPBlock(2 * D + (fi + fu + fs) * emb_size, self.dnn_layers, "Dice",
                                       output_dim=1, dropout_rate=self.dropout, norm="batch_norm")
        # the attention map `BaseRunner.check` logs (the JAX model sows it)
        self.intermediates = None

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--att_layers", type=str, default="[64]",
                            help="Size of each layer in the attention module.")
        parser.add_argument("--dnn_layers", type=str, default="[64]",
                            help="Size of each layer in the MLP module.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["att_layers"] = tuple(ast.literal_eval(args.att_layers))
        kw["dnn_layers"] = tuple(ast.literal_eval(args.dnn_layers))
        return kw

    def target_attention(self, current, history, lengths, training, gen):
        """current [B, C, D], history [B, H, D], lengths [B] -> [B, C, D]:
        the masked, sqrt(D)-scaled, unnormalised weights of the attention
        MLP times the history."""
        B, C, D = current.shape
        H = history.shape[1]
        q = current[:, :, None, :].expand(B, C, H, D)
        k = history[:, None, :, :].expand(B, C, H, D)
        w = self.att_mlp_layers(torch.cat([q, k, q - k, q * k], dim=-1), training, gen)[..., 0]
        valid = torch.arange(H, device=lengths.device)[None, None, :] < lengths[:, None, None]
        w = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device)) / math.sqrt(D)
        self.intermediates = {"din_attention": w.detach()} if layers.recording() else None
        return torch.einsum("bch,bhd->bcd", w, history)

    def prediction(self, feed, training, gen):
        g = self.group_embeddings(feed)
        B, C = g["item"].shape[:2]
        history, current = sequence_embeddings(self, g)
        ctx = [g["item"], broadcast_candidates(g["user"], C)]
        if "situ" in g:
            ctx.append(broadcast_candidates(g["situ"], C))
        all_context = torch.cat(ctx, dim=-2).reshape(B, C, -1)
        user_his = self.target_attention(current, history, feed["lengths"], training, gen)
        din_in = torch.cat([user_his, user_his * current, all_context], dim=-1)
        return self.dnn_mlp_layers(din_in, training, gen)[..., 0], None


@register_model("DINCTR")
class DINCTR(DINBase, ContextSeqCTRModel):
    pass


@register_model("DINTopK")
class DINTopK(DINBase, ContextSeqModel):
    pass
