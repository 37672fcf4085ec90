"""ContraRec -- sequential recommendation with multiple contrast signals
(port of rechorus_tpu/models/sequential/contrarec.py).

Reference behavior: src/models/sequential/ContraRec.py (Wang et al.,
TOIS'22): CTC loss = temperature-scaled softmax cross-entropy over the
candidates; CCC loss = supervised InfoNCE (`losses.infonce`; ContraLoss,
142-195) over TWO augmented views of the history (`ContraBatcher`: mask
and reorder ops with Beta(a, b) ratios, 106-140), where in-batch rows
sharing the target item count as positives. Encoders: GRU4Rec, Caser,
BERT4Rec (197-276). As in the JAX package the CCC labels are the TRUE
target ids (the reference takes column 0 of the permuted candidates).
It has no catalog protocol: full-catalog evaluation goes through its
forward.
CMD example:
  python -m rechorus_tpu_torch.main --model_name ContraRec --emb_size 64 --lr 1e-4 --l2 1e-6 \
      --history_max 20 --encoder BERT4Rec --gamma 1 --batch_size 4096 \
      --dataset Grocery_and_Gourmet_Food
"""
from __future__ import annotations

import math
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from rechorus_tpu_torch.models.base import SequentialModel, target_col
from rechorus_tpu_torch.ops import losses
from rechorus_tpu_torch.ops.layers import (Dense, LayerNorm, MaskedGRU, TransformerLayer,
                                           _truncated_normal, _zeros, dropout, embed)
from rechorus_tpu_torch.registry import register_model


def last_valid(seq, lengths):
    """[B, d] row lengths - 1 (0 for an empty row) of seq [B, L, d]."""
    last = (lengths - 1).clamp(min=0)
    return seq.gather(1, last[:, None, None].expand(seq.shape[0], 1, seq.shape[2]))[:, 0]


class BERT4RecEncoder(nn.Module):
    """Bidirectional transformer over the valid positions (reference
    ContraRec.py:253-276): `forward` gives the state at lengths - 1,
    `encode_all` every position, zero past the length (S3Rec's MIP head).
    S3Rec's variant (`input_ln`) LayerNorms the position-added input and
    drops it at `dropout` (reference S3Rec.py:186-205); ContraRec's and
    CLRec's does not."""

    def __init__(self, emb_size: int, max_his: int, num_layers: int = 2, num_heads: int = 2,
                 input_ln: bool = False, dropout: float = 0.0):
        super().__init__()
        self.num_layers, self.input_ln, self.dropout = num_layers, input_ln, dropout
        self.p_embeddings = embed(max_his + 1, emb_size)
        for k in range(num_layers):
            self.add_module(f"trm_{k}", TransformerLayer(emb_size, emb_size, num_heads))
        if input_ln:
            self.layer_norm = LayerNorm(emb_size)

    def encode_all(self, seq, lengths, training: bool = False, gen=None):
        L = seq.shape[1]
        valid = torch.arange(L, device=seq.device)[None, :] < lengths[:, None]
        seq = seq + self.p_embeddings(torch.arange(L, device=seq.device)[None, :] * valid)
        if self.input_ln:
            seq = dropout(self.layer_norm(seq), self.dropout, training, gen)
        mask = valid[:, None, None, :]
        for k in range(self.num_layers):
            seq = getattr(self, f"trm_{k}")(seq, mask=mask, training=training, gen=gen)
        return seq * valid[:, :, None]

    def forward(self, seq, lengths, training: bool = False, gen=None):
        return last_valid(self.encode_all(seq, lengths, training, gen), lengths)


class GRUEncoder(nn.Module):
    """GRU + a linear head without bias (reference GRU4RecEncoder,
    ContraRec.py:199-218)."""

    def __init__(self, emb_size: int, hidden_size: int = 128):
        super().__init__()
        self.rnn = MaskedGRU(emb_size, hidden_size)
        self.out = Dense(hidden_size, emb_size, use_bias=False)

    def forward(self, seq, lengths, training: bool = False, gen=None):
        return self.out(self.rnn(seq, lengths)[1])


def _conv_lecun_normal(shape, gen):
    """flax nn.Conv's default kernel init: lecun-normal over the kernel's
    fan-in (in channels x kernel height x width)."""
    return _truncated_normal(shape, gen, 1.0 / math.prod(shape[1:]))


class CaserEncoder(nn.Module):
    """Horizontal + vertical convolutions (reference CaserEncoder,
    ContraRec.py:220-251). The history image is NCHW [B, 1, L, D] here
    (flax: NHWC); the vertical conv's output is flattened in flax's
    [D, channels] order, so `fc` sees the same features. The convs start
    as flax's nn.Conv does: lecun-normal kernels, zero biases."""

    def __init__(self, emb_size: int, max_his: int, num_horizon: int = 16, num_vertical: int = 8,
                 l: int = 5):
        super().__init__()
        self.l = l
        self.conv_v = nn.Conv2d(1, num_vertical, kernel_size=(max_his, 1))
        for i in range(1, l + 1):
            self.add_module(f"conv_h_{i}", nn.Conv2d(1, num_horizon, kernel_size=(i, emb_size)))
        for m in self.children():
            m.PARAM_INITS = {"weight": _conv_lecun_normal, "bias": _zeros}
        self.fc = Dense(num_vertical * emb_size + num_horizon * l, emb_size)

    def forward(self, seq, lengths, training: bool = False, gen=None):
        B = seq.shape[0]
        img = seq[:, None]                                                  # [B, 1, L, D]
        outs = [self.conv_v(img).permute(0, 2, 3, 1).reshape(B, -1)]        # flax order [D, C]
        for i in range(1, self.l + 1):
            outs.append(torch.relu(getattr(self, f"conv_h_{i}")(img)[:, :, :, 0]).amax(dim=2))
        return self.fc(torch.cat(outs, dim=1))


@register_model("ContraRec")
class ContraRec(SequentialModel):
    batch_coupled: ClassVar[bool] = True   # in-batch contrast
    batcher: ClassVar[str] = "contra"
    extra_log_args: ClassVar[list] = ["gamma", "num_neg", "batch_size", "ctc_temp", "ccc_temp", "encoder"]

    def __init__(self, *, emb_size: int = 64, gamma: float = 1.0, beta_a: int = 3, beta_b: int = 3,
                 ctc_temp: float = 1.0, ccc_temp: float = 0.2, encoder: str = "BERT4Rec", **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.gamma, self.beta_a, self.beta_b = emb_size, gamma, beta_a, beta_b
        self.ctc_temp, self.ccc_temp, self.encoder_name = ctc_temp, ccc_temp, encoder
        # one row past the catalog: the mask token of the augmented views
        self.i_embeddings = embed(self.item_num + 1, emb_size)
        if encoder == "GRU4Rec":
            self.encoder = GRUEncoder(emb_size, hidden_size=128)
        elif encoder == "Caser":
            self.encoder = CaserEncoder(emb_size, self.history_max, num_horizon=16, num_vertical=8, l=5)
        elif encoder == "BERT4Rec":
            self.encoder = BERT4RecEncoder(emb_size, self.history_max, num_layers=2, num_heads=2)
        else:
            raise ValueError("Invalid sequence encoder.")

    @staticmethod
    def parse_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--gamma", type=float, default=1, help="Coefficient of the contrastive loss.")
        parser.add_argument("--beta_a", type=int, default=3,
                            help="Parameter of the beta distribution for sampling.")
        parser.add_argument("--beta_b", type=int, default=3,
                            help="Parameter of the beta distribution for sampling.")
        parser.add_argument("--ctc_temp", type=float, default=1,
                            help="Temperature in context-target contrastive loss.")
        parser.add_argument("--ccc_temp", type=float, default=0.2,
                            help="Temperature in context-context contrastive loss.")
        parser.add_argument("--encoder", type=str, default="BERT4Rec",
                            help="Choose a sequence encoder: GRU4Rec, Caser, BERT4Rec.")
        return SequentialModel.parse_model_args(parser)

    def lazy_table_specs(self) -> dict:
        # out of --lazy_emb_adam: the views' mask-token rows are gathered
        # inside the model, under no feed key, so a touched-rows update
        # would miss their gradients
        return {}

    def forward(self, feed, training: bool = False, gen=None):
        lengths = feed["lengths"]

        def encode(history):
            return self.encoder(self.i_embeddings(history), lengths, training=training, gen=gen)

        his_vector = encode(feed["history_items"])
        i_vectors = self.i_embeddings(feed["item_id"])
        out = {"prediction": (his_vector[:, None, :] * i_vectors).sum(-1)}
        if training and "history_items_a" in feed:
            features = torch.stack([encode(feed["history_items_a"]), encode(feed["history_items_b"])], dim=1)
            out["features"] = losses.l2_normalize(features)
            out["labels"] = feed["item_id"].gather(1, target_col(feed)[:, None])[:, 0]
        return out

    def loss(self, out_dict, feed):
        predictions = out_dict["prediction"] / self.ctc_temp
        ctc_loss = -self.ctc_temp * F.log_softmax(predictions, dim=1)[:, 0].mean()
        labels = out_dict["labels"]
        ccc_loss = self.ccc_temp * losses.infonce(out_dict["features"], temperature=self.ccc_temp,
                                                  same_target_mask=labels[:, None] == labels[None, :])
        return ctc_loss + self.gamma * ccc_loss
