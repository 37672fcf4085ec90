"""BPRMF (Rendle et al., UAI'09; ReChorus 2.0 src/models/general/BPRMF.py):
score(u, i) = u_emb[u] . i_emb[i], trained with ReChorus's BPR loss."""
from __future__ import annotations

from . import bpr

# trains and ranks rows with position > 0, each with its history
SEQUENTIAL = False


def param_shapes(config: dict) -> dict:
    d = config["emb_size"]
    return {"u_embeddings.weight": (config["n_users"], d),
            "i_embeddings.weight": (config["n_items"], d)}


def param_count(config: dict) -> int:
    return sum(a * b for a, b in param_shapes(config).values())


def forward_flops(config: dict, rows: int, candidates: int) -> float:
    """Multiply-adds x 2 of scoring `rows` users against `candidates` items
    each."""
    return 2.0 * rows * candidates * config["emb_size"]


def item_table(config: dict, w: dict):
    return w["i_embeddings.weight"]


def user_vectors(config: dict, w: dict, rows: dict):
    """[B, D] of rows["user"]."""
    return w["u_embeddings.weight"][rows["user"]]


def prediction(config: dict, w: dict, rows: dict):
    """[B, C] scores of rows["user"] against rows["items"] [B, C]."""
    u = user_vectors(config, w, rows)
    return (u[:, None, :] * w["i_embeddings.weight"][rows["items"]]).sum(-1)


def loss(config: dict, w: dict, rows: dict):
    return bpr.loss(prediction(config, w, rows))
