"""DIEN -- deep interest evolution network (port of
rechorus_tpu/models/context_seq/dien.py).

Reference behavior: src/models/context_seq/DIEN.py (Zhou et al., AAAI'19;
FuxiCTR-derived): an interest-extraction GRU over the history, target
attention, the interest-evolving AGRU / AUGRU / AIGRU, an FCN head; with
--alpha_aux > 0 an auxiliary next-item loss against a sampled negative
history. As in the JAX package:
  * the extractor GRU runs once per batch, not once per candidate (the
    reference repeats identical inputs per item, DIEN.py:144-148): the
    same outputs;
  * the target attention softmaxes over the HISTORY axis (the reference
    softmaxes its flattened batch axis, DIEN.py:124);
  * the negative history is drawn per step from the step's generator (the
    reference draws it per epoch on the host, DIEN.py:195-205).
The extractor is `MaskedGRU` (one cuDNN call); the evolving GRU is
`AttentionalGRU`, a loop over the H steps of the [B, C] rows.
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextSeqCTRModel, ContextSeqModel
from rechorus_tpu_torch.models.context._modes import ContextHead, mode_out
from rechorus_tpu_torch.models.context_seq.din import broadcast_candidates, group_widths, sequence_embeddings
from rechorus_tpu_torch.ops.layers import AttentionalGRU, MaskedGRU, MLPBlock, _unit_normal
from rechorus_tpu_torch.ops.losses import masked_softmax
from rechorus_tpu_torch.registry import register_model


class DIENBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "evolving_gru_type", "fcn_hidden_layers"]

    def __init__(self, *, emb_size: int = 64, evolving_gru_type: str = "AGRU", fcn_hidden_layers=(64,),
                 fcn_activations: str = "ReLU", aux_hidden_layers=(64,), aux_activations: str = "ReLU",
                 alpha_aux: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.evolving_gru_type = emb_size, evolving_gru_type
        self.fcn_hidden_layers, self.fcn_activations = tuple(fcn_hidden_layers), fcn_activations
        self.aux_hidden_layers, self.aux_activations = tuple(aux_hidden_layers), aux_activations
        self.alpha_aux = alpha_aux
        self.init_group_embeddings(emb_size)
        _, fu, fs, fh = group_widths(self)
        D = fh * emb_size
        self.gru = MaskedGRU(D, D)
        self.attentionW = nn.Parameter(torch.empty(D, D))
        self.PARAM_INITS = {"attentionW": _unit_normal}
        self.evolving_gru = AttentionalGRU(D, D, evolving_gru_type)
        # the FCN's input: user, situation, target, history sum, their
        # product, the evolved interest
        self.fcn_in = (fu + fs) * emb_size + 4 * D
        self.fcn_net = self.head_mlp(self.fcn_in)
        if alpha_aux > 0:
            self.aux_net = MLPBlock(2 * D, self.aux_hidden_layers, aux_activations, output_dim=1,
                                    dropout_rate=self.dropout)

    def head_mlp(self, in_dim: int) -> MLPBlock:
        return MLPBlock(in_dim, self.fcn_hidden_layers, self.fcn_activations, output_dim=1,
                        dropout_rate=self.dropout)

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="the size of the embedding vectors")
        parser.add_argument("--evolving_gru_type", type=str, default="AGRU",
                            help="the type of the evolving gru: AGRU, AUGRU, AIGRU")
        parser.add_argument("--fcn_hidden_layers", type=str, default="[64]", help="hidden layers of the fcn net")
        parser.add_argument("--fcn_activations", type=str, default="ReLU", help="activation of the fcn net")
        parser.add_argument("--aux_hidden_layers", type=str, default="[64]", help="hidden layers of the aux net")
        parser.add_argument("--aux_activations", type=str, default="ReLU", help="activation of the aux net")
        parser.add_argument("--alpha_aux", type=float, default=0,
                            help="weight of auxiliary loss; aux net used only when alpha_aux>0")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw["fcn_hidden_layers"] = tuple(ast.literal_eval(args.fcn_hidden_layers))
        kw["aux_hidden_layers"] = tuple(ast.literal_eval(args.aux_hidden_layers))
        return kw

    def dien_parts(self, feed, training, gen):
        """(group embeddings, the FCN input [B, C, fcn_in], {'aux_loss'}
        when the auxiliary loss runs): everything before the head, which
        CAN extends with its co-action features."""
        extra = {}
        if self.alpha_aux > 0 and training and "history_neg_items" in feed:
            extra["history_neg"] = feed["history_neg_items"]
        g = self.group_embeddings(feed, extra_item_ids=extra)
        B, C = g["item"].shape[:2]
        history, target = sequence_embeddings(self, g)
        H = history.shape[1]
        lengths = feed["lengths"]
        # interest extraction, once per batch (its inputs do not depend on the target)
        interest, _ = self.gru(history, lengths)
        # target attention over the history axis
        scores = torch.einsum("bhd,bcd->bch", torch.matmul(interest, self.attentionW), target)
        valid = torch.arange(H, device=lengths.device)[None, None, :] < lengths[:, None, None]
        attention = masked_softmax(scores, valid.expand(B, C, H), dim=-1)
        # interest evolution per candidate
        h_out = self.evolving_gru(interest, attention, lengths)                 # [B, C, D]
        history_sum = history.sum(dim=-2)          # [B, D], pads included as in the JAX package
        parts = [broadcast_candidates(g["user"].reshape(B, -1), C)]
        if "situ" in g:
            parts.append(broadcast_candidates(g["situ"].reshape(B, -1), C))
        parts += [target, broadcast_candidates(history_sum, C), target * history_sum[:, None], h_out]
        out = {}
        if "history_neg" in g:
            neg = g["history_neg"]
            if self.add_historical_situations and "history_situ" in g:
                neg = torch.cat([neg, g["history_situ"]], dim=-2)
            out["aux_loss"] = self.aux_loss(interest, history, neg.reshape(B, H, -1), lengths, training, gen)
        return g, torch.cat(parts, dim=-1), out

    def aux_loss(self, interest, pos_emb, neg_emb, lengths, training, gen):
        """Binary next-item discrimination (reference DIEN.py:176-192): the
        interest at step t against the positive and the negative item at
        t + 1, over the steps inside each row's length."""
        pos_in = torch.cat([interest[:, :-1], pos_emb[:, 1:]], dim=-1)
        neg_in = torch.cat([interest[:, :-1], neg_emb[:, 1:]], dim=-1)
        pos_p = torch.sigmoid(self.aux_net(pos_in, training, gen)[..., 0])
        neg_p = torch.sigmoid(self.aux_net(neg_in, training, gen)[..., 0])
        eps = 1e-7
        pos_l = -torch.log(pos_p.clamp(eps, 1 - eps))
        neg_l = -torch.log((1 - neg_p).clamp(eps, 1 - eps))
        steps = torch.arange(1, pos_l.shape[1] + 1, device=lengths.device)
        mask = (steps[None, :] < lengths[:, None]).to(pos_l.dtype)
        per_row = torch.stack([(pos_l * mask).sum(-1), (neg_l * mask).sum(-1)]) / (mask.sum(-1) + 1e-9)
        return per_row.mean()

    def head(self, inp, training, gen):
        return self.fcn_net(inp, training, gen)[..., 0]

    def forward(self, feed, training: bool = False, gen=None):
        _, inp, extra = self.dien_parts(feed, training, gen)
        return {**mode_out(self, self.head(inp, training, gen), feed), **extra}

    def loss(self, out_dict, feed):
        loss = super().loss(out_dict, feed)
        if "aux_loss" in out_dict:
            loss = loss + self.alpha_aux * out_dict["aux_loss"]
        return loss


@register_model("DIENCTR")
class DIENCTR(DIENBase, ContextSeqCTRModel):
    pass


@register_model("DIENTopK")
class DIENTopK(DIENBase, ContextSeqModel):
    pass
