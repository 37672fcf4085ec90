"""Streaming rank kernel for full-catalog evaluation (counterpart of
rechorus_tpu/ops/pallas_kernels.py).

`--test_all` ranks the ground truth over the whole catalog with the
user's clicked items masked (reference BaseRunner.py:244-251 +
evaluate_method :51-78). Scatter-free, as in the JAX package:

  rank = 1 + #{j: s_j >= t} - #{clicked j: s_j >= t} - [s_0 >= t]

`ge_count` is the dominant term. On a CUDA tensor it launches
`rtt_ge_count_kernel` (csrc/catalog_kernels.cu); on a CPU tensor it runs
`ge_count_plain`.
"""
from __future__ import annotations

import torch

from rechorus_tpu_torch.ops import _build


def ge_count_plain(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """#{j: pred[b, j] >= target[b]} per row; pred [B, N], target [B] -> [B] int32."""
    return (pred >= target[:, None]).sum(1).to(torch.int32)


def ge_count(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """#{j: pred[b, j] >= target[b]} per row; pred [B, N] float32, target
    [B] float32 -> [B] int32. Kernel on CUDA tensors, plain on CPU ones."""
    if pred.device.type == "cpu":
        return ge_count_plain(pred, target)
    if pred.device.type != "cuda":
        raise ValueError(f"ge_count: no kernel for device {pred.device}")
    B, N = pred.shape
    _build.check_input("ge_count", "pred", pred, torch.float32, (B, N), pred.device)
    _build.check_input("ge_count", "target", target, torch.float32, (B,), pred.device)
    _build.check_int32("ge_count", B=B, N=N)
    counts = torch.zeros(B, dtype=torch.int32, device=pred.device)
    if B and N:
        _build.launch("rtt_ge_count", pred.device, _build.ptr(pred), _build.ptr(target),
                      _build.ptr(counts), B, N)
        ge_count.launches += 1
    return counts


ge_count.launches = 0


def catalog_ranks(pred: torch.Tensor, target_col: torch.Tensor,
                  clicked_rows: torch.Tensor) -> torch.Tensor:
    """Ground-truth rank over the full catalog with clicked-item masking
    (port of pallas_kernels.py:80-99): item 0 and every clicked item are
    excluded; ties count against the target (>=).

    pred [B, N] catalog scores; target_col [B] the target's column;
    clicked_rows [B, M] clicked ids padded with 0, unique per row, holding
    the target (its residual copy). Returns [B] int32.
    """
    clicked = clicked_rows.long()
    tscore = pred.gather(1, target_col.long()[:, None])[:, 0].contiguous()
    total = ge_count(pred, tscore)
    clicked_ge = ((pred.gather(1, clicked) >= tscore[:, None]) & (clicked > 0)).sum(1)
    zero_ge = (pred[:, 0] >= tscore).to(torch.int32)
    # the target's clicked copy is subtracted with the clicked; re-add it
    return (total - clicked_ge - zero_ge + 1).to(torch.int32)
