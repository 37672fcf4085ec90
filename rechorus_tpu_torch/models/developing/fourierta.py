"""FourierTA -- Fourier temporal attention over the history (port of
rechorus_tpu/models/developing/fourierta.py).

Reference behavior: src/models/developing/FourierTA.py: an MLP target
attention of each candidate over the history items, modulated by a
learnable inverse-DFT decay of the log-normalised interaction age
(FourierTemporalAttention, 84-120), clipped to [0, 1]; one FFN + LayerNorm
block; prediction = (u + context) . item + item bias. Its tables are raw
parameters, N(0, 0.01), gathered by plain indexing: `--lazy_emb_adam 1`
resolves no table and the first step raises, as in the JAX package.
The attention query is [B, C, H, d]: under --test_all 1 on Grocery
(C = 8,714, H = 20, d = 64) it is 11.4 GB at eval batch 256.
CMD example:
  python -m rechorus_tpu_torch.main --model_name FourierTA --emb_size 64 --lr 1e-3 --l2 1e-6 \
      --history_max 20 --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import math
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import Dense, LayerNorm, dropout
from rechorus_tpu_torch.parallel.mesh import take_rows
from rechorus_tpu_torch.registry import register_model


@register_model("FourierTA")
class FourierTA(SequentialModel):
    batcher: ClassVar[str] = "seq_delta"
    extra_log_args: ClassVar[list] = ["t_scalar"]

    def __init__(self, *, emb_size: int = 64, t_scalar: int = 60, **kwargs):
        super().__init__(**kwargs)
        d = self.emb_size = emb_size
        self.t_scalar = t_scalar
        self.user_embeddings = nn.Parameter(torch.empty(self.user_num, d))
        self.item_embeddings = nn.Parameter(torch.empty(self.item_num, d))
        self.item_bias = nn.Parameter(torch.empty(self.item_num, 1))
        self.freq_real = nn.Parameter(torch.empty(d))
        self.freq_imag = nn.Parameter(torch.empty(d))
        self.A = Dense(d, 10)
        self.A_out = Dense(10, 1, use_bias=False)
        self.W1 = Dense(d, d)
        self.W2 = Dense(d, d)
        self.layer_norm = LayerNorm(d)
        # the inverse DFT's frequencies [f, -f], f = linspace(0, 1, d) / 2
        freq = torch.linspace(0.0, 1.0, d) / 2.0
        self.register_buffer("freqs", torch.cat([freq, -freq]), persistent=False)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--t_scalar", type=int, default=60, help="Time interval scalar.")
        return SequentialModel.parse_model_args(parser)

    def forward(self, feed, training: bool = False, gen=None):
        items, history = feed["item_id"], feed["history_items"]
        u_vectors = take_rows(self.user_embeddings, feed["user_id"])                  # [B, d]
        i_vectors = take_rows(self.item_embeddings, items)                           # [B, C, d]
        his_vectors = take_rows(self.item_embeddings, history)                        # [B, H, d]
        valid = history > 0                                                # [B, H]

        # MLP target attention (FourierTA.py:110-115)
        query = his_vectors[:, None, :, :] * i_vectors[:, :, None, :]      # [B, C, H, d]
        attention = self.A_out(torch.tanh(self.A(query)))[..., 0]          # [B, C, H]
        attention = losses.masked_softmax(attention, valid[:, None, :].expand(attention.shape), dim=-1)

        # learnable inverse-DFT decay (FourierTA.py:102-108)
        x_real = torch.cat([self.freq_real, self.freq_real])
        x_imag = torch.cat([self.freq_imag, -self.freq_imag])
        w = 2.0 * math.pi * self.freqs * feed["history_delta_t"][..., None]  # [B, H, 2d]
        decay = (torch.cos(w) * x_real - torch.sin(w) * x_imag).mean(-1) / 2.0
        decay = decay.clamp(0.0, 1.0) * valid                              # [B, H]
        attention = attention * decay[:, None, :]
        context = torch.einsum("bch,bhd->bcd", attention, his_vectors)

        residual = context
        context = self.W2(torch.relu(self.W1(context)))
        context = dropout(context, self.dropout, training, gen)
        context = self.layer_norm(residual + context)

        i_bias = self.item_bias[items][..., 0]
        prediction = ((u_vectors[:, None, :] + context) * i_vectors).sum(-1) + i_bias
        return {"prediction": prediction}
