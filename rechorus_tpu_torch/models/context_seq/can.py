"""CAN -- co-action network on top of DIEN (port of
rechorus_tpu/models/context_seq/can.py).

Reference behavior: src/models/context_seq/CAN.py (Bian et al., 2022):
each candidate's "induce" embedding is cut into the weights and biases of
a micro-MLP (tanh); the user's, each situation field's and each history
step's embedding go through it (raised to `orders` powers and
concatenated), the history outputs mean-pooled over the valid steps; the
co-action outputs join DIEN's FCN input.
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch

from rechorus_tpu_torch.models.base import ContextSeqCTRModel, ContextSeqModel
from rechorus_tpu_torch.models.context._modes import mode_out
from rechorus_tpu_torch.models.context_seq.din import broadcast_candidates
from rechorus_tpu_torch.models.context_seq.dien import DIENBase
from rechorus_tpu_torch.ops.layers import embed
from rechorus_tpu_torch.registry import register_model


class CANBase(DIENBase):
    extra_log_args: ClassVar[list] = ["emb_size", "evolving_gru_type"]

    def __init__(self, *, induce_vec_size: int = 512, orders: int = 1, co_action_layers=(4, 4), **kwargs):
        super().__init__(**kwargs)
        self.induce_vec_size, self.orders = induce_vec_size, orders
        self.co_action_layers = tuple(co_action_layers)
        self.item_embedding_induce = embed(self.item_num, induce_vec_size)
        # co-action features: the user's, each situation field's, the history's
        n_feeds = 2 + len(self.source_names[2])
        self.fcn_net = self.head_mlp(self.fcn_in + n_feeds * sum(self.co_action_layers))

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--induce_vec_size", type=int, default=512,
                            help="size of the induced co-action vector")
        parser.add_argument("--orders", type=int, default=1,
                            help="orders of the feature co-action vector")
        parser.add_argument("--co_action_layers", type=str, default="[4,4]",
                            help="layers of the micro-MLP in the co-action module")
        return DIENBase.add_model_args(parser)

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["co_action_layers"] = tuple(ast.literal_eval(args.co_action_layers))
        return kw

    def micro_mlp(self, induction, feed_vec, history: bool = False) -> list:
        """The induced micro-MLP's layer outputs. induction [B, C, induce];
        feed_vec [B, C, d] -> [B, C, l] per layer, or with `history`
        [B, H, d] -> [B, H, C, l] (each step against each candidate's
        weights, never materialising them per step)."""
        h = torch.cat([feed_vec ** (i + 1) for i in range(self.orders)], dim=-1)
        pre, start, outs = h.shape[-1], 0, []
        for j, layer in enumerate(self.co_action_layers):
            w = induction[..., start: start + pre * layer]
            w = w.reshape(w.shape[:-1] + (pre, layer))
            start += pre * layer
            b = induction[..., start: start + layer]
            start += layer
            if not history:
                z = torch.einsum("bcd,bcdl->bcl", h, w) + b
            else:
                z = torch.einsum("bhd,bcdl->bhcl" if j == 0 else "bhcd,bcdl->bhcl", h, w) + b[:, None]
            h = torch.tanh(z)
            outs.append(h)
            pre = layer
        return outs

    def forward(self, feed, training: bool = False, gen=None):
        g, inp, extra = self.dien_parts(feed, training, gen)
        B, C = g["item"].shape[:2]
        induction = self.item_embedding_induce(self._items(feed))        # [B, C, induce]
        co = [torch.cat(self.micro_mlp(induction, broadcast_candidates(g["user"][:, 0], C)), dim=-1)]
        if "situ" in g:
            for s in range(g["situ"].shape[-2]):
                co.append(torch.cat(self.micro_mlp(induction, broadcast_candidates(g["situ"][:, s], C)),
                                    dim=-1))
        # the history's co-action: each step's item-id embedding, masked mean
        hist = g["history"][..., 0, :]                                   # [B, H, d]
        H = hist.shape[1]
        lengths = feed["lengths"]
        mask = (torch.arange(H, device=lengths.device)[None, :] < lengths[:, None]).to(hist.dtype)
        denom = mask.sum(dim=1).clamp(min=1.0)[:, None, None]
        co.append(torch.cat([(h * mask[:, :, None, None]).sum(dim=1) / denom
                             for h in self.micro_mlp(induction, hist, history=True)], dim=-1))
        pred = self.head(torch.cat(co + [inp], dim=-1), training, gen)
        return {**mode_out(self, pred, feed), **extra}


@register_model("CANCTR")
class CANCTR(CANBase, ContextSeqCTRModel):
    pass


@register_model("CANTopK")
class CANTopK(CANBase, ContextSeqModel):
    extra_log_args: ClassVar[list] = ["emb_size", "evolving_gru_type", "fcn_hidden_layers"]
