"""Operations and bytes of the catalog kernels and of a dense Adam step,
counted from shapes (what the algorithm needs, not what a kernel happens
to move). A model's own forward counts live beside its reference
(`reference/<model>.py`: `forward_flops`, `param_count`).

The catalog kernels score a [B, D] block of user vectors against an
[N, D] float32 table. Each input byte is read once and each output byte
written once:

- B2 `rtt_bucket_max_kernel` (serving's stage 1): 2 B N D operations;
  reads the table and the users, writes the [B, G] float32 bucket maxima,
  G = ceil(N / (bucket * 128)) * 128.
- B3 `rtt_fused_ge_kernel` (ranks): 2 B N D operations; reads the table,
  the users, the [B] target scores and target ids, writes [B] int32.
"""
from __future__ import annotations

F32 = 4
NB = 128                 # bucket maxima per catalog block (ops/cuda_topk.py)
ADAM_BYTES_PER_PARAM = 28   # read p, g, m, v; write p, m, v (float32)


def bucket_columns(n: int, bucket: int) -> int:
    return -(-n // (bucket * NB)) * NB


def b2(B: int, N: int, D: int, bucket: int = 16) -> tuple[float, float]:
    """(operations, bytes) of one B2 launch."""
    return 2.0 * B * N * D, F32 * (N * D + B * D + B * bucket_columns(N, bucket))


def b3(B: int, N: int, D: int) -> tuple[float, float]:
    """(operations, bytes) of one B3 launch."""
    return 2.0 * B * N * D, F32 * (N * D + B * D + 2 * B + B)


def catalog_scores(B: int, N: int, D: int, out_per_row: int) -> tuple[float, float]:
    """(operations, bytes) of scoring B users against the whole catalog and
    returning `out_per_row` 4-byte words a user: the model work of a
    serving or ranking batch, whatever kernels do it."""
    return 2.0 * B * N * D, F32 * (N * D + B * D + B * out_per_row)


def dense_adam_bytes(n_params: int) -> float:
    return float(ADAM_BYTES_PER_PARAM * n_params)
