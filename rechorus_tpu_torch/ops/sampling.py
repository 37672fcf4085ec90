"""Device-side negative sampling and the anti-leak candidate permutation
(port of rechorus_tpu/ops/sampling.py:17-82).

Every draw takes an explicit `torch.Generator` that lives on the device
of the tensors. Torch and JAX give different numbers from one seed, so
only shapes, ranges and the rejection rule are comparable.
"""
from __future__ import annotations

import torch


def first_accepted(cand: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """Vectorized rejection sampling with no device loop: `cand` [R, *S]
    holds R candidate sets drawn AT ONCE and `bad` [R, *S] marks the
    rejected draws; keeps, elementwise, the first accepted draw (the last
    draw if all collide -- the fallback of loop rejection). The JAX
    version vmaps a draw and a reject function over the round axis; here
    the round axis is written out and the caller passes both arrays."""
    R = cand.shape[0]
    ok = ~bad
    first = torch.where(ok.any(dim=0), ok.to(torch.int8).argmax(dim=0),
                        torch.full_like(ok[0], R - 1, dtype=torch.long))
    return cand.gather(0, first[None])[0]


def sample_negatives(gen: torch.Generator, users: torch.Tensor, clicked_pad: torch.Tensor,
                     num_neg: int, n_items: int, rounds: int = 8) -> torch.Tensor:
    """Uniform negatives in [1, n_items) avoiding each user's clicked set.

    users: [B] int64; clicked_pad: [n_users, M] padded with 0. Returns
    [B, num_neg] int64. After `rounds` resampling rounds the residual
    collision probability is (|clicked|/n_items)^rounds. The collision
    test is one [rounds+1, B, num_neg, M] broadcast compare."""
    B = users.shape[0]
    clicked = clicked_pad[users]  # [B, M]
    cand = torch.randint(1, n_items, (rounds + 1, B, num_neg), generator=gen,
                         device=users.device, dtype=clicked.dtype)
    bad = (cand[..., None] == clicked[None, :, None, :]).any(dim=-1)
    return first_accepted(cand, bad)


def candidate_permutation(gen: torch.Generator, shape, device):
    """Random per-row column permutation indices; returns (idx, inverse).

    Models can't memorize 'column 0 = target'; the runner applies idx to
    item_id, then restores predictions to original order with
    `restore_predictions` before the loss (reference BaseRunner.py:187-202).
    """
    u = torch.rand(tuple(shape), generator=gen, device=device)
    idx = torch.argsort(u, dim=-1)
    inv = torch.argsort(idx, dim=-1)
    return idx, inv


def restore_predictions(predictions: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return predictions.gather(-1, inv)
