"""In-place row scatter, the commit of the sparse lazy-Adam lanes
(counterpart of rechorus_tpu/ops/pallas_scatter.py:92-129).

`scatter_rows(table, rows, block)` writes `table[rows[i]] = block[i]` for
UNIQUE row ids and drops ids outside [0, N); rows that are not named are
neither read nor written. On a CUDA tensor it launches
`rtt_scatter_rows_kernel` (csrc/scatter_kernels.cu); on a CPU tensor it
runs `scatter_rows_plain`. The JAX version donates its table and returns
the updated buffer; here the table is updated IN PLACE and returned. The
kernel has no gradient (neither has the TPU kernel): call it under
`torch.no_grad()` on leaf tensors.
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
    if table.dim() != 2:
        raise ValueError(f"scatter_rows: table must be [N, W], got {tuple(table.shape)}")
    N, W = table.shape
    R = rows.shape[0]
    if block.dtype != table.dtype:
        raise TypeError(f"scatter_rows: block has dtype {block.dtype}, table {table.dtype}")
    _build.check_input("scatter_rows", "table", table, table.dtype, (N, W), table.device)
    _build.check_input("scatter_rows", "rows", rows, torch.int32, (R,), table.device)
    _build.check_input("scatter_rows", "block", block, table.dtype, (R, W), table.device)
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("scatter_rows has no gradient: call it under torch.no_grad()")
    if table.device.type == "cpu":
        return scatter_rows_plain(table, rows, block)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_rows: no kernel for device {table.device}")
    if R and N and W:
        _build.launch("rtt_scatter_rows", table.device, _build.ptr(table), _build.ptr(rows),
                      _build.ptr(block), N, R, W * table.element_size())
        scatter_rows.launches += 1
    return table


scatter_rows.launches = 0
