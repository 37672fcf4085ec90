"""The chip's peaks that rooflines and `mfu` are shares of.

NVIDIA's data sheet for one H100 SXM (dense, without sparsity): 67 TFLOP/s
in float32 outside the tensor cores (the port's catalog kernels and its
float32 training run there: TF32 is off) and 3.35 TB/s of HBM3. Those
rates assume the full 700 W; `power_limit_w` reads the card's limit, which
a run records beside its shares.
"""
from __future__ import annotations

import shutil
import subprocess

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the float32 peak and the bytes at the memory peak."""
    return max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S)


def power_limit_w() -> float | None:
    """The card's power limit in W as nvidia-smi reads it, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None
