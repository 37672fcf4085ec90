"""Seeding (contract of rechorus_tpu/utils/rng.py:17).

Python and numpy are seeded globally, as in the JAX package, and so is
torch's default generator (CPU and CUDA), from which module init draws.
Torch and JAX give different numbers from one seed: tests make shared
inputs with numpy.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int) -> None:
    """Seed python's, numpy's and torch's default RNGs."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
