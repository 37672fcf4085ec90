"""The benchmark's one door into the program, `rechorus_tpu_torch`: it
builds what the program's CLI builds (`main.build_stack`), from the
benchmark's own corpus and weights instead of files, in the same order:
the runner (it owns the device and the precision settings), the model,
the batcher and its arrays on the device.

The readers are built from in-memory interactions through the steps their
constructors run after reading CSV files (`_build_clicked_sets`,
`_post_read`, and `_append_his_info` where the reader has it), as
chip_smoke.py builds its 1M-item corpora.

Every import of the program happens inside a function, once the harness
has looked for a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def device_flag(device) -> str:
    """The CLI's `--gpu` for `device`: '' is the CPU."""
    device = torch.device(device)
    return "" if device.type == "cpu" else str(device.index or 0)


def runner(config: dict, traffic: dict, seed: int, device):
    from rechorus_tpu_torch import registry

    cls = registry.get_runner(config.get("runner", "BaseRunner"))
    flags = ["--lr", str(config["lr"]), "--l2", str(config["l2"]),
             "--optimizer", traffic.get("optimizer", "Adam"),
             "--batch_size", str(traffic.get("batch", 256)),
             "--eval_batch_size", str(traffic.get("eval_batch", 256))]
    args = cls.parse_runner_args(argparse.ArgumentParser()).parse_args(flags)
    args.gpu, args.random_seed = device_flag(device), int(seed)
    return cls(args)


def model(config: dict, traffic: dict, device, test_all: bool = False):
    """The configuration's model, its hyperparameters from the
    configuration's keys, its tables sized by n_users and n_items, built
    on `device` (its constructor's draws happen there, not on the host)."""
    from rechorus_tpu_torch import registry

    cls = registry.get_model(config["model"])
    names = cls.hyperparameters()
    kwargs = {k: v for k, v in config.items() if k in names}
    kwargs.update(user_num=config["n_users"], item_num=config["n_items"],
                  num_neg=traffic.get("num_neg", 1), test_all=int(test_all))
    with torch.device(device):
        return cls(**{k: v for k, v in kwargs.items() if k in names})


@torch.no_grad()
def load_weights(module: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's weights into the module's parameters; the
    names and shapes must be the reference's, leaf for leaf."""
    own = dict(module.named_parameters())
    if set(own) != set(weights):
        raise RuntimeError(f"the program's parameters {sorted(own)} are not the reference's "
                           f"{sorted(weights)}")
    for name, w in weights.items():
        if tuple(own[name].shape) != tuple(w.shape):
            raise RuntimeError(f"{name}: program {tuple(own[name].shape)}, reference {tuple(w.shape)}")
        own[name].copy_(w)


def reader(config: dict, interactions):
    """The configuration's reader class over the benchmark's interactions:
    train, dev (every user's last interaction in the sequential layout)
    and an empty test split."""
    import pandas as pd

    from rechorus_tpu_torch import registry

    model_cls = registry.get_model(config["model"])
    cls = registry.get_reader(model_cls.reader)
    corpus = cls.__new__(cls)
    frames = {}
    for split in ("train", "dev"):
        u, i, t = interactions.split(split)
        frames[split] = pd.DataFrame({"user_id": u, "item_id": i, "time": t})
    frames["test"] = frames["dev"].iloc[:0].copy()
    corpus.data_df = frames
    corpus.all_df = pd.concat([frames[k] for k in ("train", "dev", "test")])
    corpus.n_users, corpus.n_items = interactions.n_users, interactions.n_items
    corpus._build_clicked_sets()
    corpus._post_read()
    if hasattr(corpus, "_append_his_info"):
        corpus._append_his_info()
    return corpus


def batcher(corpus, model_obj, runner_obj, phase: str):
    """(batcher, its arrays placed on the runner's device)."""
    from rechorus_tpu_torch.data.batching import get_batcher

    b = get_batcher(model_obj.batcher)(corpus, model_obj, phase, runner_obj.args)
    return b, runner_obj.place_arrays(b.device_arrays(runner_obj.device))


def serve_index(model_obj, clicked: np.ndarray, n_items: int, k: int, device):
    """`ServeIndex.build` over the model, with `clicked` as the corpus's
    clicked matrix."""
    from rechorus_tpu_torch.serve import ServeIndex

    class Clicked:
        def __init__(self):
            self.n_items = n_items

        def clicked_matrix(self, include_residual: bool = False) -> np.ndarray:
            return clicked

    return ServeIndex.build(model_obj, Clicked(), k=k, device=device)
