"""The precisions a reference computes in: float64 to judge, and the
controls, the nearest precision below the one a configuration states.

- "float64": the judge.
- "tf32": float32 with TF32 matrix products (a configuration in float32
  with TF32 off, where its products are matrix products).
- "bfloat16": a configuration in float32 whose arithmetic has no matrix
  product for TF32 to change.
"""
from __future__ import annotations

import contextlib

import torch

DTYPES = {"float64": torch.float64, "tf32": torch.float32, "bfloat16": torch.bfloat16}


def dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@contextlib.contextmanager
def products(name: str):
    """TF32 matrix products on inside the block for "tf32", off for every
    other precision; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])
