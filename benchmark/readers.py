"""Arithmetic shared by the per-layer readers (`metrics/<name>.py`).

Each reader takes `run`: the traced window's `trace` (tracing.Trace),
`window_s`, `units` (batches or steps), the cell's `shape`, `config`,
`traffic` and reference module `ref`; it returns a number, or None when
the trace holds nothing for it to read (no device ops, no launch of its
kernel), and the harness then leaves the metric out.
"""
from __future__ import annotations

from benchmark import peaks


def has_device(run) -> bool:
    return bool(run.trace.device) and run.units > 0 and run.window_s > 0


def idle_pct(run):
    """The share of the window in which no device op ran, in %."""
    if not has_device(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / 1e6 / run.window_s)


def ms_per_unit_except(run, kernel: str):
    """Device ms per unit of every device op but `kernel`; None when the
    kernel never ran (the layer it bounds is not on this path)."""
    if not has_device(run) or not run.trace.launches(lambda n: kernel in n):
        return None
    rest = run.trace.device_us() - run.trace.device_us(lambda n: kernel in n)
    return rest / 1e3 / run.units


def roofline_pct(run, kernel: str, flops: float, n_bytes: float):
    """The least time of one launch at the chip's peaks over the kernel's
    mean device time a launch, in %."""
    d = run.trace.launches(lambda n: kernel in n) if run.trace.device else []
    if not d:
        return None
    return 100.0 * peaks.bound_s(flops, n_bytes) / (sum(d) / len(d) / 1e6)


def mfu_pct(run, flops: float, n_bytes: float):
    """The least time the window's model work (`flops`, `n_bytes` in all)
    takes at the chip's peaks over the window, in %."""
    if not has_device(run):
        return None
    return 100.0 * peaks.bound_s(flops, n_bytes) / run.window_s
