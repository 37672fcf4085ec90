"""Adam with L2 folded into the gradient, as torch.optim.Adam(weight_decay=l2)
applies it, over the parameters whose names do not contain 'bias'
(ReChorus 2.0, src/models/BaseModel.py `customize_parameters`)."""
from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def init(params: dict) -> dict:
    return {"count": 0, "m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def step(params: dict, grads: dict, state: dict, lr: float, l2: float) -> dict:
    """One step, in place; returns the gradients the moments took (with
    their L2 term)."""
    state["count"] += 1
    bc1, bc2 = 1.0 - B1 ** state["count"], 1.0 - B2 ** state["count"]
    taken = {}
    for k, p in params.items():
        g = grads[k]
        if l2 > 0 and "bias" not in k:
            g = g + l2 * p
        m, v = state["m"][k], state["v"][k]
        m.mul_(B1).add_(g, alpha=1.0 - B1)
        v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + EPS))
        taken[k] = g
    return taken
