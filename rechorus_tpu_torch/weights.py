"""Carry flax parameters and optimizer state of a rechorus_tpu model into
its torch twin, and torch parameters back.

The flax trees arrive as nested dicts of numpy arrays (`jax.device_get`
of `state.params` / of the optimizer state's moments); this module needs
neither jax nor flax. Each model adds one entry to `FLAX_TO_TORCH`: the
flax module paths it has (regular expressions over '/'-joined paths) and
the kind of each module, which fixes how its leaves cross:

  embed       `embedding` -> `weight`
  dense       `kernel` [in, out] -> `weight` [out, in] (transposed), `bias`
  layer_norm  `scale` -> `weight`, `bias`
  conv        `kernel` HWIO -> `weight` OIHW, `bias`
  param       a raw top-level parameter (flax `self.param`), the same
              name and axes on both sides

The torch module path is the flax one with '/' -> '.' and flax's
`GRUCell_0` -> `cell`. Every transform is a permutation of axes, so a
round trip flax -> torch -> flax is exact.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_GRU = r"(ir|iz|in|hr|hz|hn)"
FLAX_TO_TORCH: Dict[str, Dict[str, str]] = {
    "BPRMF": {"u_embeddings": "embed", "i_embeddings": "embed"},
    "POP": {"_unused": "param"},
    "NeuMF": {"(mf|mlp)_[ui]_embeddings": "embed", r"mlp_\d+": "dense", "prediction": "dense"},
    "DirectAU": {"u_embeddings": "embed", "i_embeddings": "embed"},
    "LightGCN": {"(user|item)_emb": "param"},
    "BUIR": {"(user|item)_online": "embed", "predictor": "dense"},
    "CFKG": {"e_embeddings": "embed", "r_embeddings": "embed"},
    "SASRec": {"i_embeddings": "embed", "p_embeddings": "embed",
               r"transformer_\d+/mha/[qkv]": "dense", r"transformer_\d+/ff[12]": "dense",
               r"transformer_\d+/ln[12]": "layer_norm"},
    "GRU4Rec": {"i_embeddings": "embed", rf"rnn/GRUCell_0/{_GRU}": "dense", "out": "dense"},
    "NARM": {"i_embeddings": "embed", rf"encoder_[gl]/GRUCell_0/{_GRU}": "dense",
             "A1": "dense", "A2": "dense", "attention_out": "dense", "out": "dense"},
    "Caser": {"i_embeddings": "embed", "u_embeddings": "embed", r"conv_(v|h_\d+)": "conv",
              "fc": "dense", "out": "dense"},
    "FPMC": {"ui_embeddings": "embed", "iu_embeddings": "embed", "li_embeddings": "embed",
             "il_embeddings": "embed"},
    "KDA": {"user_embeddings": "embed", "entity_embeddings": "embed", "item_bias": "embed",
            "relation_embeddings": "param", "freq_(real|imag)": "param",
            r"attn_\d+/[qkv]": "dense", r"w[12]_\d+": "dense", "A": "dense", "A_out": "dense",
            r"ln_\d+": "layer_norm"},
    "TiSASRec": {"i_embeddings": "embed", "[pt]_[kv]_embeddings": "embed",
                 r"block_\d+/([qkv]|ff[12])": "dense", r"block_\d+/ln[12]": "layer_norm"},
    "ComiRec": {"[ip]_embeddings": "embed", "W[12]": "dense"},
    "SLRCPlus": {"global_alpha": "param", "(alphas|pis|mus|betas|sigmas)": "embed",
                 "[ui]_embeddings": "embed", "(user|item)_bias": "embed"},
    "Chorus": {"([uir]_embeddings|betas|mus|sigmas|prediction_w|(user|item)_bias)": "param"},
    "ContraRec": {"i_embeddings": "embed", "encoder/p_embeddings": "embed",
                  r"encoder/trm_\d+/(mha/[qkv]|ff[12])": "dense", r"encoder/trm_\d+/ln[12]": "layer_norm",
                  rf"encoder/rnn/GRUCell_0/{_GRU}": "dense", "encoder/(out|fc)": "dense",
                  r"encoder/conv_(v|h_\d+)": "conv"},
    "TiMiRec": {"interest_(extractor|predictor)/[ip]_embeddings": "embed",
                "interest_extractor/W[12]": "dense",
                "interest_extractor/transformer/(mha/[qkv]|ff[12])": "dense",
                "interest_extractor/transformer/ln[12]": "layer_norm",
                rf"interest_predictor/rnn/GRUCell_0/{_GRU}": "dense", r"proj_(\d+|final)": "dense"},
}
FLAX_TO_TORCH["ContraKDA"] = FLAX_TO_TORCH["KDA"]
# kind -> {flax leaf: (torch leaf, flax -> torch axes)}; None keeps the axes
_LEAVES = {
    "embed": {"embedding": ("weight", None)},
    "dense": {"kernel": ("weight", (1, 0)), "bias": ("bias", None)},
    "layer_norm": {"scale": ("weight", None), "bias": ("bias", None)},
    "conv": {"kernel": ("weight", (3, 2, 0, 1)), "bias": ("bias", None)},
}


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _kind(model: str, module: str) -> str:
    for pattern, kind in FLAX_TO_TORCH[model].items():
        if re.fullmatch(pattern, module):
            return kind
    raise KeyError(f"{model}: unmapped flax module {module!r}")


def _torch_leaf(model: str, path) -> tuple:
    """(state_dict key, flax -> torch axes) of one flax leaf path."""
    if len(path) == 1:  # a raw top-level parameter
        if _kind(model, path[0]) != "param":
            raise KeyError(f"{model}: unmapped flax leaf {path[0]!r}")
        return path[0], None
    module = "/".join(path[:-1])
    leaves = _LEAVES[_kind(model, module)]
    if path[-1] not in leaves:
        raise KeyError(f"{model}: unmapped flax leaf {'/'.join(path)!r}")
    name, axes = leaves[path[-1]]
    return ".".join(p if p != "GRUCell_0" else "cell" for p in path[:-1]) + "." + name, axes


def _to_torch(tree: Mapping, model: str) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _leaves(tree):
        key, axes = _torch_leaf(model, path)
        arr = np.array(leaf, dtype=np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr.transpose(axes) if axes else arr))
    return out


def from_flax_params(params: Mapping, model: str = "BPRMF") -> Dict[str, torch.Tensor]:
    """torch `state_dict` (float32) for `model` from its flax param tree.
    A module or leaf that `FLAX_TO_TORCH[model]` does not know raises."""
    return _to_torch(params, model)


def to_flax_params(state_dict: Mapping[str, torch.Tensor], model: str = "BPRMF") -> dict:
    """The inverse of `from_flax_params`: the nested flax param tree (numpy
    float32 leaves) of a torch `state_dict`, so a model trained here can
    be scored by the JAX package."""
    tree: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) == 1:  # a raw top-level parameter
            if _kind(model, key) != "param":
                raise KeyError(f"{model}: unmapped torch parameter {key!r}")
            tree[key] = value.detach().float().cpu().numpy().copy()
            continue
        path = ["GRUCell_0" if p == "cell" else p for p in parts[:-1]]
        leaves = _LEAVES[_kind(model, "/".join(path))]
        match = [(f, axes) for f, (t, axes) in leaves.items() if t == parts[-1]]
        if not match:
            raise KeyError(f"{model}: unmapped torch parameter {key!r}")
        flax_leaf, axes = match[0]
        arr = value.detach().float().cpu().numpy()
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[flax_leaf] = np.ascontiguousarray(arr.transpose(np.argsort(axes)) if axes else arr)
    return tree


def from_flax_opt_state(count, mu: Mapping, nu: Mapping, model: str = "BPRMF"):
    """(count, mu, nu) of an Adam state for the port: `count` as int, the
    two moment trees (those of optax's `ScaleByAdamState` or of the JAX
    package's `LazyAdamState`, as numpy) as {state_dict key: float32
    tensor}, each leaf crossing as its parameter does. The caller puts
    them into a `DenseOptState` (`slots["mu"]`, `slots["nu"]`) or a
    `LazyAdamState`."""
    return int(count), _to_torch(mu, model), _to_torch(nu, model)
