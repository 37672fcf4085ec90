"""In-place row scatter (counterpart of
rechorus_tpu/ops/pallas_scatter.py:92-129).

`scatter_rows(table, rows, block)` writes `table[rows[i]] = block[i]` for
UNIQUE row ids and drops ids outside [0, N); rows that are not named are
neither read nor written. On a CUDA tensor it launches
`rtt_scatter_rows_kernel` (csrc/scatter_kernels.cu); on a CPU tensor it
runs `scatter_rows_plain`. The JAX version donates its table and returns
the updated buffer; here the table is updated IN PLACE and returned. The
kernel has no gradient (neither has the TPU kernel): call it under
`torch.no_grad()` on leaf tensors. The sparse lazy-Adam lanes commit
through the other instance of its row walk, `lazy_adam.adam_commit`,
which computes the rows it writes.
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.ops import _build


def scatter_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                       block: torch.Tensor) -> torch.Tensor:
    """table[rows[i]] = block[i] in place for unique rows; ids outside
    [0, N) dropped. table [N, W]; rows [R] integer; block [R, W]."""
    rows = rows.long()
    keep = (rows >= 0) & (rows < table.shape[0])
    table[rows[keep]] = block[keep]
    return table


def scatter_rows(table: torch.Tensor, rows: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """table[rows[i]] = block[i] IN PLACE for unique rows, ids outside
    [0, N) dropped; returns `table`. table [N, W] and block [R, W] of one
    dtype (any 1/2/4/8-byte type, any width), rows [R] int32, all
    contiguous on one device. Kernel on CUDA tensors, plain on CPU ones."""
    try:
        N, W = table.shape
    except ValueError:
        raise ValueError(f"scatter_rows: table must be [N, W], got {tuple(table.shape)}") from None
    R = rows.shape[0]
    dtype, dev = table.dtype, table.device
    if not table.is_contiguous():
        raise ValueError("scatter_rows: table must be contiguous")
    _build.check_input("scatter_rows", "rows", rows, torch.int32, (R,), dev)
    _build.check_input("scatter_rows", "block", block, dtype, (R, W), dev)
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("scatter_rows has no gradient: call it under torch.no_grad()")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return scatter_rows_plain(table, rows, block)
        raise ValueError(f"scatter_rows: no kernel for device {dev}")
    if R and N and W:
        _build.launchers.rtt_scatter_rows(dev.index, table.data_ptr(), rows.data_ptr(),
                                          block.data_ptr(), N, R, W * table.element_size())
        scatter_rows.launches += 1
    return table


scatter_rows.launches = 0
