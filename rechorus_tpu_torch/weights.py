"""Carry flax parameters and optimizer state of a rechorus_tpu model into
its torch twin, and torch parameters back.

The flax trees arrive as nested dicts of numpy arrays (`jax.device_get`
of `state.params` / of the optimizer state's moments); this module needs
neither jax nor flax. Each model adds one entry to `FLAX_TO_TORCH`: flax
parameter path -> torch `state_dict` key.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

FLAX_TO_TORCH: Dict[str, Dict[Tuple[str, ...], str]] = {
    "BPRMF": {
        ("u_embeddings", "embedding"): "u_embeddings.weight",
        ("i_embeddings", "embedding"): "i_embeddings.weight",
    },
}


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _mapped(tree: Mapping, model: str) -> Dict[str, np.ndarray]:
    """{state_dict key: leaf}. Every flax leaf must be mapped and every
    mapped path present; either gap raises."""
    mapping = FLAX_TO_TORCH[model]
    leaves = dict(_leaves(tree))
    unmapped = sorted(set(leaves) - set(mapping))
    missing = sorted(set(mapping) - set(leaves))
    if unmapped or missing:
        raise KeyError(f"{model}: unmapped flax params {unmapped}, missing {missing}")
    return {key: leaves[path] for path, key in mapping.items()}


def from_flax_params(params: Mapping, model: str = "BPRMF") -> Dict[str, torch.Tensor]:
    """torch `state_dict` (float32) for `model` from its flax param tree."""
    return {key: torch.from_numpy(np.array(leaf, dtype=np.float32))
            for key, leaf in _mapped(params, model).items()}


def to_flax_params(state_dict: Mapping[str, torch.Tensor], model: str = "BPRMF") -> dict:
    """The inverse of `from_flax_params`: the nested flax param tree (numpy
    float32 leaves) of a torch `state_dict`, so a table trained here can be
    scored by the JAX package."""
    mapping = FLAX_TO_TORCH[model]
    missing = sorted(set(mapping.values()) - set(state_dict))
    if missing:
        raise KeyError(f"{model}: state_dict lacks {missing}")
    tree: dict = {}
    for path, key in mapping.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = state_dict[key].detach().float().cpu().numpy()
    return tree


def from_flax_opt_state(count, mu: Mapping, nu: Mapping, model: str = "BPRMF"):
    """(count, mu, nu) of an Adam state for the port: `count` as int, the
    two moment trees (those of optax's `ScaleByAdamState` or of the JAX
    package's `LazyAdamState`, as numpy) as {state_dict key: float32
    tensor}. The caller puts them into a `DenseOptState`
    (`slots["mu"]`, `slots["nu"]`) or a `LazyAdamState`."""
    as_tensors = lambda tree: {key: torch.from_numpy(np.array(leaf, dtype=np.float32))
                               for key, leaf in _mapped(tree, model).items()}
    return int(count), as_tensors(mu), as_tensors(nu)
