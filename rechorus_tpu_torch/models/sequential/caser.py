"""Caser -- convolutional sequence embedding (port of
rechorus_tpu/models/sequential/caser.py).

Reference behavior: src/models/sequential/Caser.py (Tang & Wang, WSDM'18):
horizontal convs of heights 1..L max-pooled over time + a vertical conv
over the time axis, concatenated through fc, combined with the user
embedding. Pad item 0 embeds to zeros (reference padding_idx=0). The
history image is NCHW [B, 1, T, E] here (flax: NHWC [B, T, E, 1]); the
vertical conv's output is laid out as flax flattens it ([E, channels]),
so `fc` sees the same feature order.
"""
from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel
from rechorus_tpu_torch.ops.layers import Dense, embed
from rechorus_tpu_torch.registry import register_model


@register_model("Caser")
class Caser(SequentialModel):
    extra_log_args: ClassVar[list] = ["emb_size", "num_horizon", "num_vertical", "L"]
    supports_catalog: ClassVar[bool] = True

    def __init__(self, *, emb_size: int = 64, num_horizon: int = 16, num_vertical: int = 8,
                 L: int = 4, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.num_horizon, self.num_vertical, self.L = emb_size, num_horizon, num_vertical, L
        self.i_embeddings = embed(self.item_num, emb_size)
        self.u_embeddings = embed(self.user_num, emb_size)
        # both convs start N(0, 0.01), kernel and bias (the default of
        # BaseModel.init_weights), as in the JAX model
        if num_vertical > 0:
            self.conv_v = nn.Conv2d(1, num_vertical, kernel_size=(self.history_max, 1))
        for h in range(1, L + 1) if num_horizon > 0 else ():
            self.add_module(f"conv_h_{h}", nn.Conv2d(1, num_horizon, kernel_size=(h, emb_size)))
        fc_in = num_vertical * emb_size + (num_horizon * L if num_horizon > 0 else 0)
        self.fc = Dense(fc_in, emb_size)
        self.out = Dense(2 * emb_size, emb_size)

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--num_horizon", type=int, default=16, help="Number of horizon convolution kernels.")
        parser.add_argument("--num_vertical", type=int, default=8, help="Number of vertical convolution kernels.")
        parser.add_argument("--L", type=int, default=4, help="Union window size.")
        return SequentialModel.parse_model_args(parser)

    def forward(self, feed, catalog: bool = False, training: bool = False, gen=None):
        history = feed["history_items"]                                  # [B, T]
        B = history.shape[0]
        his = self.i_embeddings(history) * (history > 0)[:, :, None]     # padding_idx=0
        img = his[:, None]                                               # [B, 1, T, E]
        outs = []
        if self.num_vertical > 0:
            out_v = self.conv_v(img)                                     # [B, C, 1, E]
            outs.append(out_v.permute(0, 2, 3, 1).reshape(B, -1))        # flax order: [E, C]
        if self.num_horizon > 0:
            for h in range(1, self.L + 1):
                conv = torch.relu(getattr(self, f"conv_h_{h}")(img)[:, :, :, 0])   # [B, C, T-h+1]
                outs.append(conv.amax(dim=2))                            # max-pool over time
        user_vector = self.u_embeddings(feed["user_id"])
        z = torch.relu(self.fc(torch.cat(outs, dim=1)))
        his_vector = self.out(torch.cat([z, user_vector], dim=1))
        if catalog:
            return {"u_v": his_vector}
        i_vectors = self.i_embeddings(feed["item_id"])
        return {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}
