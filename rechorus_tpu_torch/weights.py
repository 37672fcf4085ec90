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
  batch_norm  `scale` -> `weight`, `bias`, and from the flax `batch_stats`
              collection `mean` -> `running_mean`, `var` -> `running_var`
  conv        `kernel` HWIO -> `weight` OIHW, `bias`
  embed_or_dense  a module that is an embed or a dense by the data (FinalMLP's
              feature-selection embeddings): its flax leaf says which
  param       raw parameters (flax `self.param`), the same name and axes on
              both sides: a top-level one, or every leaf of the module
  constant    a top-level leaf of the flax `constants` collection that the
              torch model keeps as a persistent buffer of the same name
              (ETA's and SDIM's LSH rotations)
  target      a top-level leaf of BUIR's `target` collection, a persistent
              buffer of the same name here (the EMA tables)

The torch module path is the flax one with '/' -> '.', flax's
`GRUCell_0` -> `cell`, and a BiLSTM's `OptimizedLSTMCell_0` / `_1` (flax
names the cells of its two `nn.RNN`s after the cell class) -> `fwd.cell` /
`bwd.cell`. Every transform is a permutation of axes, so a
round trip flax -> torch -> flax is exact.

Checkpoints: `write_checkpoint` writes the file the JAX package's
`BaseRunner.save_model` writes, flax's msgpack of {"params",
"extra_vars"} (`flax_variables`), and `read_checkpoint` reads it, or a
`torch.save` state_dict file (told apart by its zip magic), to
state_dict entries. Every checkpoint read of the port goes through it.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from rechorus_tpu_torch.utils import flax_msgpack

_GRU = r"(ir|iz|in|hr|hz|hn)"
FLAX_TO_TORCH: Dict[str, Dict[str, str]] = {
    "BPRMF": {"u_embeddings": "embed", "i_embeddings": "embed"},
    "POP": {"_unused": "param"},
    "NeuMF": {"(mf|mlp)_[ui]_embeddings": "embed", r"mlp_\d+": "dense", "prediction": "dense"},
    "DirectAU": {"u_embeddings": "embed", "i_embeddings": "embed"},
    "LightGCN": {"(user|item)_emb": "param"},
    "BUIR": {"(user|item)_online": "embed", "predictor": "dense", "(user|item)_target": "target"},
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
_BERT4REC = {"i_embeddings": "embed", "encoder/p_embeddings": "embed",
             r"encoder/trm_\d+/(mha/[qkv]|ff[12])": "dense", r"encoder/trm_\d+/ln[12]": "layer_norm"}
FLAX_TO_TORCH.update({
    "CLRec": _BERT4REC,
    "S3Rec": {**_BERT4REC, "encoder/layer_norm": "layer_norm", "(mip|sp)_norm": "dense"},
    "FourierTA": {"(user|item)_embeddings": "param", "item_bias": "param", "freq_(real|imag)": "param",
                  "(A|A_out|W1|W2)": "dense", "layer_norm": "layer_norm"},
    "SRGNN": {"i_embeddings": "param", "gnn": "param", "gnn/linear_edge_(in|out)": "dense",
              "linear(1|2|3|_transform)": "dense"},
})
FLAX_TO_TORCH["ContraKDA"] = FLAX_TO_TORCH["KDA"]
for _name in ("BPRMF", "LightGCN", "SASRec", "GRU4Rec"):
    FLAX_TO_TORCH[_name + "Impression"] = FLAX_TO_TORCH[_name]
# a re-ranker's --tuneranker submodule: any of the four Impression rankers
_RANKER = {"ranker_module": "param",
           **{"ranker_module/" + k: v for _name in ("BPRMF", "LightGCN", "SASRec", "GRU4Rec")
              for k, v in FLAX_TO_TORCH[_name].items()}}
_MAB = r"(msab_\d+|imsab_\d+_[12])"
_RERANK = {
    "PRM": {"i_embeddings": "embed", "ordinal_position_embedding": "embed", "rFF[01]": "dense",
            r"encoder_\d+/(mha/([qkv]|out_proj)|ff[12])": "dense", r"encoder_\d+/ln[12]": "layer_norm"},
    "SetRank": {"i_embeddings": "embed", "ordinal_position_embedding": "embed", "rFF[01]": "dense",
                r"inducing_\d+": "param", rf"{_MAB}/(attn/([qkv]|out_proj)|linear[12])": "dense",
                rf"{_MAB}/norm[12]": "layer_norm"},
    "MIR": {"i_embeddings": "embed", "intra_set/([qkv]|out_proj)": "dense",
            "intra_list/OptimizedLSTMCell_[01]/(ii|if|ig|io|hi|hf|hg|ho)": "dense",
            "SLAttention": "param", "SLAttention/fc_decay[12]": "dense", "fc[1-4]": "dense"},
}
for _name, _mapping in _RERANK.items():
    FLAX_TO_TORCH[_name + "General"] = FLAX_TO_TORCH[_name + "Sequential"] = {**_mapping, **_RANKER}
# flax module names -> torch module paths (and back, by `_flax_module_path`)
_RENAME = {"GRUCell_0": "cell", "OptimizedLSTMCell_0": "fwd.cell", "OptimizedLSTMCell_1": "bwd.cell"}
_BANK = {"bank/(fused_table|fused_linear)": "embed", r"bank/float_(emb|lin)_\d+": "dense"}


def _mlp(prefix: str) -> dict:
    return {rf"{prefix}/(dense_\d+|head)": "dense", rf"{prefix}/bn_\d+": "batch_norm"}


_CONTEXT = {
    "FM": {**_BANK, "overall_bias": "param"},
    "WideDeep": {**_BANK, "overall_bias": "param", **_mlp("deep_layers")},
    "AFM": {**_BANK, "(overall_bias|p|attlayer)": "param", "attlayer/w": "dense"},
    "DCN": {**_BANK, r"cross_[wb]_\d+": "param", **_mlp("deep_layers"), "predict_layer": "dense"},
    "DCNv2": {**_BANK, r"cross_(w2|b|u|v|c)_\d+": "param", r"gating_\d+": "dense",
              **_mlp("deep_layers"), "predict_layer": "dense"},
    "xDeepFM": {**_BANK, "overall_bias": "param", **_mlp("deep_layers"), r"cin_[wb]_\d+": "param",
                "cin_linear": "dense"},
    "AutoInt": {**_BANK, "overall_bias": "param", r"att_\d+/([qkv]|out_proj)": "dense",
                r"residual_\d+": "dense", **_mlp("deep_layers")},
    "SAM": {**_BANK, "block": "param", r"block/[KQ]_\d+": "dense", "output_layer": "dense"},
    "FinalMLP": {**_BANK, r"(fs[12]_ctx_bias|w_xy)": "param", r"fs[12]_emb_\d+": "embed_or_dense",
                 **_mlp(r"(mlp[12]|fs[12]_gate)"), "w_[xy]": "dense"},
}
_GROUPS = {"fused_table": "embed", "float_.+": "dense"}
_DIEN = {**_GROUPS, rf"gru/GRUCell_0/{_GRU}": "dense", "(attentionW|evolving_gru)": "param",
         **_mlp("(fcn_net|aux_net)")}
_ETA = {**_GROUPS, r"(short|long)_attention_\d+/W_[qkvo]": "dense", **_mlp("dnn"),
        r"random_rotations_\d+": "constant"}
_CONTEXT.update({
    "DIN": {**_GROUPS, **_mlp("(att|dnn)_mlp_layers"), r"dnn_mlp_layers/dice_\d+": "param",
            r"dnn_mlp_layers/dice_\d+/bn": "batch_norm"},
    "DIEN": _DIEN,
    "CAN": {**_DIEN, "item_embedding_induce": "embed"},
    "ETA": _ETA,
    "SDIM": _ETA,
})
_CONTEXT["DeepFM"] = _CONTEXT["WideDeep"]
for _name, _mapping in _CONTEXT.items():
    FLAX_TO_TORCH[_name + "CTR"] = FLAX_TO_TORCH[_name + "TopK"] = _mapping
# kind -> {flax leaf: (torch leaf, flax -> torch axes)}; None keeps the axes
_LEAVES = {
    "embed": {"embedding": ("weight", None)},
    "dense": {"kernel": ("weight", (1, 0)), "bias": ("bias", None)},
    "layer_norm": {"scale": ("weight", None), "bias": ("bias", None)},
    "conv": {"kernel": ("weight", (3, 2, 0, 1)), "bias": ("bias", None)},
    "batch_norm": {"scale": ("weight", None), "bias": ("bias", None),
                   "mean": ("running_mean", None), "var": ("running_var", None)},
    "embed_or_dense": {"embedding": ("weight", None), "kernel": ("weight", (1, 0)),
                       "bias": ("bias", None)},
}
# flax leaves of the `batch_stats` collection; every other leaf is a param
_BATCH_STATS = {"mean", "var"}
# the flax collection of each top-level kind
_TOP_LEVEL = {"param": "params", "constant": "constants", "target": "target"}


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
    if len(path) == 1:  # a raw top-level parameter, constant or target
        if _kind(model, path[0]) not in _TOP_LEVEL:
            raise KeyError(f"{model}: unmapped flax leaf {path[0]!r}")
        return path[0], None
    module = "/".join(path[:-1])
    kind = _kind(model, module)
    if kind == "param":  # a raw parameter of a submodule
        return ".".join(path), None
    leaves = _LEAVES[kind]
    if path[-1] not in leaves:
        raise KeyError(f"{model}: unmapped flax leaf {'/'.join(path)!r}")
    name, axes = leaves[path[-1]]
    return ".".join(_RENAME.get(p, p) for p in path[:-1]) + "." + name, axes


def _flax_module_path(torch_parts) -> list:
    """The flax module path of a torch module path (`_RENAME` inverted)."""
    dotted = "." + ".".join(torch_parts) + "."
    for flax_name, torch_name in sorted(_RENAME.items(), key=lambda kv: -len(kv[1])):
        dotted = dotted.replace("." + torch_name + ".", "." + flax_name + ".")
    return dotted.strip(".").split(".")


def _to_torch(tree: Mapping, model: str) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _leaves(tree):
        key, axes = _torch_leaf(model, path)
        if isinstance(leaf, torch.Tensor):      # a bfloat16 leaf of a checkpoint
            leaf = leaf.float().numpy()
        arr = np.array(leaf, dtype=np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr.transpose(axes) if axes else arr))
    return out


def from_flax_params(params: Mapping, model: str = "BPRMF") -> Dict[str, torch.Tensor]:
    """torch `state_dict` entries (float32) for `model` from its flax param
    tree, from its `batch_stats` tree (the BatchNorm running buffers), from
    the `constant` leaves of its `constants` tree or from BUIR's `target`
    tree. A module or leaf that `FLAX_TO_TORCH[model]` does not know
    raises."""
    return _to_torch(params, model)


def _host(value: torch.Tensor, keep_dtype: bool):
    """A tensor on the host: numpy float32, or with `keep_dtype` in its own
    dtype (a bfloat16 one stays a torch tensor: numpy has no bfloat16)."""
    t = value.detach().cpu()
    if not keep_dtype:
        t = t.float()
    return t if t.dtype == torch.bfloat16 else t.numpy().copy()


def _transpose(arr, axes):
    if isinstance(arr, torch.Tensor):
        return arr.permute(*axes).contiguous()
    return np.ascontiguousarray(arr.transpose(axes))


def to_flax_params(state_dict: Mapping[str, torch.Tensor], model: str = "BPRMF",
                   collection: str = "params", keep_dtype: bool = False) -> dict:
    """The inverse of `from_flax_params`: the nested flax tree of the
    `collection` ('params', 'batch_stats', 'constants' or 'target') that a
    torch `state_dict` holds, so a model trained here can be scored by the
    JAX package. Entries of the other collections are left out. Leaves are
    numpy float32, or with `keep_dtype` in the tensor's dtype (bfloat16
    tables as torch tensors)."""
    tree: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) == 1:  # a raw top-level parameter, constant or target
            kind = _kind(model, key)
            if kind not in _TOP_LEVEL:
                raise KeyError(f"{model}: unmapped torch parameter {key!r}")
            if collection == _TOP_LEVEL[kind]:
                tree[key] = _host(value, keep_dtype)
            continue
        path = _flax_module_path(parts[:-1])
        kind = _kind(model, "/".join(path))
        if kind == "param":
            match = [(parts[-1], None)]
        else:
            match = [(f, axes) for f, (t, axes) in _LEAVES[kind].items() if t == parts[-1]]
        if len(match) > 1:  # embed_or_dense: a Dense(1 -> d) weight is [d, 1]
            match = [m for m in match if (m[0] == "kernel") == (value.shape[-1] == 1)]
        if not match:
            raise KeyError(f"{model}: unmapped torch parameter {key!r}")
        flax_leaf, axes = match[0]
        if ("batch_stats" if flax_leaf in _BATCH_STATS else "params") != collection:
            continue
        arr = _host(value, keep_dtype)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[flax_leaf] = _transpose(arr, tuple(np.argsort(axes))) if axes else arr
    return tree


def flax_leaf_path(model: str, key: str, value) -> tuple | None:
    """The flax path of the `params` leaf that the torch parameter `key`
    (of shape value.shape) crosses to, or None when it crosses to another
    collection: what the JAX package's sharding rule reads."""
    parts = key.split(".")
    if len(parts) == 1:
        return (key,) if _TOP_LEVEL.get(_kind(model, key)) == "params" else None
    path = _flax_module_path(parts[:-1])
    kind = _kind(model, "/".join(path))
    if kind == "param":
        return tuple(path) + (parts[-1],)
    match = [f for f, (t, _) in _LEAVES[kind].items() if t == parts[-1]]
    if len(match) > 1:  # embed_or_dense: a Dense(1 -> d) weight is [d, 1]
        match = [f for f in match if (f == "kernel") == (value.shape[-1] == 1)]
    if not match or match[0] in _BATCH_STATS:
        return None
    return tuple(path) + (match[0],)


def from_flax_opt_state(count, mu: Mapping, nu: Mapping, model: str = "BPRMF"):
    """(count, mu, nu) of an Adam state for the port: `count` as int, the
    two moment trees (those of optax's `ScaleByAdamState` or of the JAX
    package's `LazyAdamState`, as numpy) as {state_dict key: float32
    tensor}, each leaf crossing as its parameter does. The caller puts
    them into a `DenseOptState` (`slots["mu"]`, `slots["nu"]`) or a
    `LazyAdamState`."""
    return int(count), _to_torch(mu, model), _to_torch(nu, model)


# ------------------------------------------------------------ checkpoints
# the first bytes of a `torch.save` file (a zip archive)
ZIP_MAGIC = b"PK\x03\x04"
_EXTRA_COLLECTIONS = ("batch_stats", "constants", "target")


def _sorted(tree):
    """Maps with sorted keys, as the JAX package's trees (jax tree maps
    sort dict keys) come out of its optimizer step."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def flax_variables(model, state_dict=None) -> dict:
    """{"params": ..., "extra_vars": {collection: tree}}: the tree the JAX
    package's `save_model` writes for `model`'s registered class, every
    leaf in the dtype its TrainState holds (f32, bfloat16 tables under
    --bf16_emb, the corpus matrices' int32). The extra collections are the
    ones the class has: `batch_stats`, `constants` (those of the
    state_dict and the corpus-derived ones of the model's `flax_constants`)
    and BUIR's `target`. `state_dict` stands in for the model's own (a
    mesh run's tables gathered whole, parallel.mesh.full_state_dict)."""
    name = model.registered_name
    state = model.state_dict() if state_dict is None else state_dict
    extra = {}
    for collection in _EXTRA_COLLECTIONS:
        tree = to_flax_params(state, name, collection, keep_dtype=True)
        if collection == "constants":
            tree.update(getattr(model, "flax_constants", dict)())
        if tree:
            extra[collection] = tree
    return _sorted({"params": to_flax_params(state, name, "params", keep_dtype=True),
                    "extra_vars": extra})


def write_checkpoint(model, path: str, state_dict=None) -> None:
    """Write `flax_variables(model, state_dict)` as flax's msgpack (the JAX
    package's `--ckpt_format flax` file)."""
    data = flax_msgpack.serialize(flax_variables(model, state_dict))
    with open(path, "wb") as f:
        f.write(data)


def read_checkpoint(path: str, model, device=None) -> Dict[str, torch.Tensor]:
    """state_dict entries of `model` (a module or its registered class
    name) from a checkpoint file: a `torch.save` state_dict (the files this
    package wrote before it wrote flax ones) or flax's msgpack of
    {"params", "extra_vars"} (`write_checkpoint`'s and the JAX package's),
    by the file's first bytes. A flax file gives every entry it holds, as
    float32 (bfloat16 values exactly), except the `constants` a model
    rebuilds from the corpus (its `flax_constants`); on `device` if given,
    else on the CPU."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == ZIP_MAGIC:
        import io

        return torch.load(io.BytesIO(data), map_location=device or "cpu", weights_only=True)
    try:
        tree = flax_msgpack.restore(data)
        params = tree["params"]
    except Exception as e:
        raise ValueError(f"{path} is neither a torch state_dict file nor a flax msgpack "
                         "checkpoint of {'params', 'extra_vars'}") from e
    name = model if isinstance(model, str) else model.registered_name
    out = from_flax_params(params, name)
    for collection, sub in (tree.get("extra_vars") or {}).items():
        if collection == "constants":
            sub = {k: v for k, v in sub.items() if _kind_or_none(name, k) == "constant"}
        elif collection not in _EXTRA_COLLECTIONS:
            continue
        out.update(from_flax_params(sub, name))
    return {k: v.to(device) for k, v in out.items()} if device is not None else out


def _kind_or_none(model: str, module: str):
    try:
        return _kind(model, module)
    except KeyError:
        return None
