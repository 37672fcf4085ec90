"""The first stage of the re-ranking pipeline: `<ranker_name>Impression`
built from the CLI args overlaid with its YAML config, and its checkpoint
loaded (port of rechorus_tpu/models/reranker/_loader.py; reference
src/models/BaseRerankerModel.py:40-66).

The checkpoint is read by `weights.read_checkpoint`: the flax msgpack file
that `BaseRunner.save_model` of either package writes, or a state_dict
file of this package. As in the JAX package, a missing checkpoint only
warns and leaves the ranker at its random initialisation.

As in the JAX package, the loaded ranker is NOT re-initialised afterwards:
every reference re-ranker's __init__ ends with `self.apply(self.init_weights)`
after loading it (e.g. PRM.py:55), which re-randomizes the frozen first
stage (PARITY.md's re-rank section).
"""
from __future__ import annotations

import copy
import logging
import os

import torch
import yaml

from rechorus_tpu_torch.weights import read_checkpoint


def resolve_path(args, name: str) -> str:
    """`name` itself if it exists, else model/<ranker_name>Impression/<name>."""
    if os.path.exists(name):
        return name
    return os.path.join("model", f"{args.ranker_name}Impression", name)


def ranker_args(args):
    """The CLI args overlaid with the ranker's YAML config, except
    history_max (reference BaseRerankerModel.py:53-56)."""
    r_args = copy.deepcopy(args)
    cfg_path = resolve_path(args, args.ranker_config_file)
    if os.path.isfile(cfg_path):
        with open(cfg_path, "r", encoding="utf-8") as f:
            cfg = yaml.safe_load(f.read()) or {}
        for k, v in cfg.items():
            if k != "history_max":
                setattr(r_args, k, v)
    else:
        logging.warning("Ranker config %s not found; using CLI args as-is", cfg_path)
    return r_args


def load_ranker(args, corpus, device):
    """The frozen ranker on `device`, in eval mode, its parameters without
    gradient: drawn from --random_seed, then loaded from its checkpoint."""
    from rechorus_tpu_torch import registry

    r_args = ranker_args(args)
    ranker = registry.get_model(args.ranker_name, "Impression").from_args(r_args, corpus).to(device)
    ranker.init_weights(torch.Generator(device=device).manual_seed(int(getattr(args, "random_seed", 0))))
    model_path = resolve_path(args, args.ranker_model_file)
    if os.path.isfile(model_path):
        try:
            state = read_checkpoint(model_path, ranker, device)
        except Exception as e:
            raise ValueError(
                f"Ranker checkpoint {model_path} is not a checkpoint of {ranker.registered_name}: "
                "neither the flax msgpack file of BaseRunner.save_model (either package) nor a "
                "state_dict file of this package") from e
        ranker.load_state_dict(state)
        logging.info("Loaded frozen ranker from %s", model_path)
    else:
        logging.warning("Ranker checkpoint %s not found; ranker is randomly initialized", model_path)
    ranker.eval()
    for p in ranker.parameters():
        p.requires_grad_(False)
    return ranker
