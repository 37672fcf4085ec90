"""FinalMLP -- two MLP streams with feature selection and a bilinear
fusion (port of rechorus_tpu/models/context/finalmlp.py).

Reference behavior: src/models/context/FinalMLP.py (Mao et al., AAAI'23;
FuxiCTR-derived FeatureSelection / InteractionAggregation).
`--fs1_context` / `--fs2_context` name the features that gate each stream:
a name ending in `_f` is embedded by a Dense(1 -> d), any other by its own
table sized by the feature's slice of the fused vocabulary, so a name must
be a categorical feature of the schema or end in `_f` (Grocery's
`i_category` is neither: use user_id / item_id there).
"""
from __future__ import annotations

import ast
from typing import ClassVar

import torch
from torch import nn

from rechorus_tpu_torch.models.base import ContextCTRModel, ContextModel
from rechorus_tpu_torch.models.context._modes import ContextHead
from rechorus_tpu_torch.ops.feature_bank import FeatureEmbeddingBank
from rechorus_tpu_torch.ops.layers import Dense, MLPBlock, _xavier_normal_heads, _zeros, embed
from rechorus_tpu_torch.registry import register_model


class FinalMLPBase(ContextHead):
    extra_log_args: ClassVar[list] = ["emb_size", "loss_n", "use_fs"]

    def __init__(self, *, emb_size: int = 64, mlp1_hidden_units=(64, 64, 64),
                 mlp1_hidden_activations: str = "ReLU", mlp1_dropout: float = 0.0,
                 mlp1_batch_norm: int = 0, mlp2_hidden_units=(64, 64, 64),
                 mlp2_hidden_activations: str = "ReLU", mlp2_dropout: float = 0.0,
                 mlp2_batch_norm: int = 0, use_fs: int = 1, fs_hidden_units=(64,),
                 fs1_context=(), fs2_context=(), num_heads: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.emb_size, self.use_fs, self.num_heads = emb_size, use_fs, num_heads
        self.fs1_context, self.fs2_context = tuple(fs1_context), tuple(fs2_context)
        self.bank = FeatureEmbeddingBank(self.total_vocab, self.feature_kinds, emb_size)
        D = len(self.feature_kinds) * emb_size
        self.PARAM_INITS = {}
        if use_fs:
            for tag, ctx in (("1", self.fs1_context), ("2", self.fs2_context)):
                if not ctx:
                    self.register_parameter(f"fs{tag}_ctx_bias", nn.Parameter(torch.zeros(1, emb_size)))
                    self.PARAM_INITS[f"fs{tag}_ctx_bias"] = _zeros
                for i, name in enumerate(ctx):
                    self.add_module(f"fs{tag}_emb_{i}", Dense(1, emb_size) if name.endswith("_f")
                                    else embed(self._fs_vocab(name), emb_size))
                self.add_module(f"fs{tag}_gate", MLPBlock(emb_size * max(1, len(ctx)),
                                                          tuple(fs_hidden_units), "ReLU", output_dim=D))
        self.mlp1 = MLPBlock(D, tuple(mlp1_hidden_units), mlp1_hidden_activations,
                             dropout_rate=mlp1_dropout, norm="batch_norm" if mlp1_batch_norm else None)
        self.mlp2 = MLPBlock(D, tuple(mlp2_hidden_units), mlp2_hidden_activations,
                             dropout_rate=mlp2_dropout, norm="batch_norm" if mlp2_batch_norm else None)
        dx, dy = self.mlp1.out_dim, self.mlp2.out_dim
        self.w_x, self.w_y = Dense(dx, 1), Dense(dy, 1)
        self.w_xy = nn.Parameter(torch.empty(num_heads, dx // num_heads, dy // num_heads))
        self.PARAM_INITS["w_xy"] = _xavier_normal_heads

    @staticmethod
    def add_model_args(parser):
        parser.add_argument("--emb_size", type=int, default=64, help="Size of embedding vectors.")
        parser.add_argument("--mlp1_hidden_units", type=str, default="[64,64,64]", help="Hidden units list of MLP1.")
        parser.add_argument("--mlp1_hidden_activations", type=str, default="ReLU", help="Hidden activation of MLP1.")
        parser.add_argument("--mlp1_dropout", type=float, default=0, help="Dropout rate of MLP1.")
        parser.add_argument("--mlp1_batch_norm", type=int, default=0, help="BatchNorm in MLP1.")
        parser.add_argument("--mlp2_hidden_units", type=str, default="[64,64,64]", help="Hidden units list of MLP2.")
        parser.add_argument("--mlp2_hidden_activations", type=str, default="ReLU", help="Hidden activation of MLP2.")
        parser.add_argument("--mlp2_dropout", type=float, default=0, help="Dropout rate of MLP2.")
        parser.add_argument("--mlp2_batch_norm", type=int, default=0, help="BatchNorm in MLP2.")
        parser.add_argument("--use_fs", type=int, default=1, help="Whether to use feature selection module.")
        parser.add_argument("--fs_hidden_units", type=str, default="[64]", help="Hidden units of feature selection.")
        parser.add_argument("--fs1_context", type=str, default="", help="Context features for MLP1, comma-split.")
        parser.add_argument("--fs2_context", type=str, default="", help="Context features for MLP2, comma-split.")
        parser.add_argument("--num_heads", type=int, default=1, help="Number of heads in the fusion module.")
        return parser

    @classmethod
    def corpus_kwargs(cls, args, corpus):
        kw = super().corpus_kwargs(args, corpus)
        kw.update(
            mlp1_hidden_units=tuple(ast.literal_eval(args.mlp1_hidden_units)),
            mlp2_hidden_units=tuple(ast.literal_eval(args.mlp2_hidden_units)),
            fs_hidden_units=tuple(ast.literal_eval(args.fs_hidden_units)),
            fs1_context=tuple(f for f in args.fs1_context.split(",") if f),
            fs2_context=tuple(f for f in args.fs2_context.split(",") if f))
        return kw

    def _fs_vocab(self, ctx: str) -> int:
        """A categorical feature's vocabulary: its slice of the fused table."""
        cat_names = [n for n, k in zip(self.feature_names, self.feature_kinds) if k == "cat"]
        i = cat_names.index(ctx)
        end = self.feature_offsets[i + 1] if i + 1 < len(self.feature_offsets) else self.total_vocab
        return end - self.feature_offsets[i]

    def _fs_gate(self, feed, flat_emb, ctx_names, tag: str, training, gen):
        B, C = flat_emb.shape[:2]
        if not ctx_names:
            fs_input = getattr(self, f"fs{tag}_ctx_bias")[None].expand(B, C, self.emb_size)
        else:
            parts = []
            for i, ctx in enumerate(ctx_names):
                val = self.feature_value(feed, ctx)                          # [B, C]
                emb = getattr(self, f"fs{tag}_emb_{i}")
                parts.append(emb(val[..., None].float()) if ctx.endswith("_f") else emb(val.long()))
            fs_input = torch.cat(parts, dim=-1)
        gate = getattr(self, f"fs{tag}_gate")(fs_input, training, gen)
        return flat_emb * (torch.sigmoid(gate) * 2)

    def fusion(self, x, y):
        """Bilinear multi-head aggregation (reference FinalMLP.py:223-248)."""
        out = self.w_x(x) + self.w_y(y)                                    # [B, C, 1]
        B, C = x.shape[:2]
        hx = x.reshape(B, C, self.num_heads, -1)
        hy = y.reshape(B, C, self.num_heads, -1)
        xy = torch.einsum("bchx,hxy,bchy->bch", hx, self.w_xy, hy).sum(-1, keepdim=True)
        return (out + xy)[..., 0]

    def prediction(self, feed, training, gen):
        flat_emb = self.flat_embeddings(feed)
        if self.use_fs:
            feat1 = self._fs_gate(feed, flat_emb, self.fs1_context, "1", training, gen)
            feat2 = self._fs_gate(feed, flat_emb, self.fs2_context, "2", training, gen)
        else:
            feat1 = feat2 = flat_emb
        return self.fusion(self.mlp1(feat1, training, gen), self.mlp2(feat2, training, gen)), None


@register_model("FinalMLPCTR")
class FinalMLPCTR(FinalMLPBase, ContextCTRModel):
    pass


@register_model("FinalMLPTopK")
class FinalMLPTopK(FinalMLPBase, ContextModel):
    pass
