"""Everything a run makes from `--seed`: the interactions, the clicked ids
a serving request excludes, and the weights.

The same seed gives the same arrays on every machine. Host arrays come
from numpy's PCG64 (`default_rng`); weights come from a torch.Generator on
the run's device, one draw for all leaves of a model. The generators are
the benchmark's own: a later change to the program leaves them alone, so
two versions of the program get the same inputs.

The corpus layouts are copies of chip_smoke.py's `SeededCorpus` (uniform
(user, item) pairs) and `seq_corpus_1m` (a run of interactions per user at
rising times, the last one held out as dev), and `clicked_ids` of its
`_clicked_matrix`, rewritten so that user ids are 1 .. n_users - 1 in both
and the dev split holds every user's last interaction.
"""
from __future__ import annotations

import numpy as np
import torch


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for `seed` (any whole number) and a stream tag."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))


# ------------------------------------------------------------------ corpus
class Interactions:
    """(user, item, time) rows of one configuration, and the dev split.

    layout "uniform": `n_interactions` pairs, user uniform in
    [1, n_users), item uniform in [1, n_items), time = row number; no dev.
    layout "sequences": users 1 .. n_users - 1, `per_user` interactions
    each at rising times (a random start, then one a minute), items
    uniform in [1, n_items); each user's last interaction is dev."""

    def __init__(self, config: dict, seed: int):
        corpus = config["corpus"]
        rng = host_rng(seed, 1)
        n_users, n_items = config["n_users"], config["n_items"]
        self.n_users, self.n_items = n_users, n_items
        if corpus["layout"] == "uniform":
            n = corpus["n_interactions"]
            self.user = rng.integers(1, n_users, size=n).astype(np.int64)
            self.item = rng.integers(1, n_items, size=n).astype(np.int64)
            self.time = np.arange(n, dtype=np.int64)
            self.is_dev = np.zeros(n, dtype=bool)
        elif corpus["layout"] == "sequences":
            p = corpus["per_user"]
            users = np.arange(1, n_users, dtype=np.int64)
            self.user = np.repeat(users, p)
            start = rng.integers(0, 10 ** 8, size=len(users))
            self.time = np.repeat(start, p) + np.tile(np.arange(p, dtype=np.int64) * 60, len(users))
            self.item = rng.integers(1, n_items, size=len(self.user)).astype(np.int64)
            self.is_dev = np.tile(np.arange(p) == p - 1, len(users))
        else:
            raise ValueError(f"unknown corpus layout {corpus['layout']!r}")

    def split(self, name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(user, item, time) of the train or dev rows, in generation order."""
        keep = ~self.is_dev if name == "train" else self.is_dev
        return self.user[keep], self.item[keep], self.time[keep]


def clicked_ids(n_users: int, n_items: int, m: int, seed: int) -> np.ndarray:
    """[n_users, m] int32: row u holds m distinct ids in [1, n_items),
    ascending (row 0 too; it is never served)."""
    rng = host_rng(seed, 2)
    base = rng.integers(1, n_items - m, size=(n_users, m))
    return (np.sort(base, axis=1) + np.arange(m)).astype(np.int32)


# ------------------------------------------------------------------ weights
def leaf_std(name: str, shape, config: dict) -> float | None:
    """The spread of one leaf's draw; None for a leaf that starts at a
    constant (a 1-D `weight`: LayerNorm's scale, 1). Tables (names with
    `embeddings`) take the configuration's `embedding_std`; other 2-D
    leaves 1/sqrt(fan_in); other 1-D leaves (biases) 0.01, the reference
    ReChorus init."""
    if "embeddings" in name:
        return float(config["init"]["embedding_std"])
    if len(shape) == 2:
        return float(shape[1]) ** -0.5
    if name.endswith("weight"):
        return None
    return 0.01


def make_weights(shapes: dict, config: dict, seed: int, device) -> dict:
    """{leaf name: float32 tensor on `device`} for the {name: shape} of a
    model, from one normal draw over all leaves on the device."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=device_generator(seed, 3, device), device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        std = leaf_std(name, shape, config)
        piece = flat[at: at + size].view(shape)
        out[name] = torch.ones(shape, device=device) if std is None else piece * std
        at += size
    return out


def plant_clicked(u_table: torch.Tensor, i_table: torch.Tensor, clicked: np.ndarray, n: int) -> None:
    """Add to each user's vector the vectors of its first `n` clicked
    items, in place: a user leans toward what it clicked, so its clicked
    ids score near the top and the serving path's clicked knockout has
    winners to remove."""
    if n <= 0:
        return
    ids = torch.from_numpy(np.ascontiguousarray(clicked[:, :n])).to(u_table.device).long()
    u_table += i_table[ids].sum(1)
