"""Carry flax parameters of a rechorus_tpu model into its torch twin.

The flax tree arrives as nested dicts of numpy arrays (`jax.device_get`
of `state.params`); this module needs neither jax nor flax. Each model
adds one entry to `FLAX_TO_TORCH`: flax parameter path -> torch
`state_dict` key.
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


def from_flax_params(params: Mapping, model: str = "BPRMF") -> Dict[str, torch.Tensor]:
    """torch `state_dict` for `model` from its flax param tree. Every flax
    leaf must be mapped and every mapped path present; either gap raises."""
    mapping = FLAX_TO_TORCH[model]
    leaves = dict(_leaves(params))
    unmapped = sorted(set(leaves) - set(mapping))
    missing = sorted(set(mapping) - set(leaves))
    if unmapped or missing:
        raise KeyError(f"{model}: unmapped flax params {unmapped}, missing {missing}")
    return {key: torch.from_numpy(np.array(leaves[path], dtype=np.float32))
            for path, key in mapping.items()}
